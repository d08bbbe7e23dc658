"""PyTorch port: the W4A8 kernel's persistent launch
(``ops/kernels.py::quantized_matmul_w4a8_stacked_persistent``), the fused
step's ``proj_kernel`` option and ``bf16_matmul_stacked``, against the JAX
reference on the CPU (Pallas kernels in interpret mode).

Inputs are made with numpy from seeds and handed to both packages; the
steps go through the rounding replay of ``tests/test_torch_fused.py``."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.models import fused as JF
from ee274_convexcaldera_llm_quantization_tpu.ops import kernels as JK
from ee274_convexcaldera_llm_quantization_tpu_torch.models import fused as TF
from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama as TL
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as TK

from test_torch_fused import (  # noqa: F401 (a fixture)
    _loop_over_seeds, _one_torch_thread, _params, _port_config)


def _packed(rng, shape, bits):
    # 8-bit offset-binary codes live in [0, 2 * maxq] = [0, 254]
    return rng.integers(0, 255 if bits == 8 else 256, size=shape,
                        dtype=np.uint8)


class TestPersistentKernel:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    @pytest.mark.parametrize("M", [1, 8, 33])
    def test_matches_grid_kernel_and_reference(self, bits, M):
        rng = np.random.default_rng(300 + 7 * bits + M)
        Lk, N, K = 3, 96, 256
        x = rng.normal(size=(M, K)).astype(np.float32)
        packed = _packed(rng, (Lk, N, K // (8 // bits)), bits)
        scales = rng.uniform(0.001, 0.02, size=(Lk, N, 1)).astype(np.float32)
        t = (torch.from_numpy(x), torch.from_numpy(packed),
             torch.from_numpy(scales), 2, bits)
        j = (jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
             jnp.asarray(2, jnp.int32), bits)
        y = TK.quantized_matmul_w4a8_stacked_persistent(*t)
        ref = np.asarray(JK.quantized_matmul_w4a8_stacked_persistent(
            *j, interpret=True))
        # each package's persistent kernel is its grid kernel, bit for bit
        assert torch.equal(y, TK.quantized_matmul_w4a8_stacked(*t))
        np.testing.assert_array_equal(ref, np.asarray(
            JK.quantized_matmul_w4a8_stacked(*j, interpret=True)))
        # the same int8 codes and exact i32 sums on both sides; the
        # reference's interpret-mode epilogue rounds (acc * s) * sx on its
        # own (one f32 ulp of the output, on ~40% of seeds)
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())

    def test_act_scale_and_rules(self):
        rng = np.random.default_rng(310)
        x = rng.normal(size=(4, 128)).astype(np.float32)
        packed = _packed(rng, (2, 64, 64), 4)
        scales = rng.uniform(0.001, 0.02, size=(2, 64, 1)).astype(np.float32)
        act = np.full((4, 1), np.abs(x).max() / 127.0, np.float32)
        t = (torch.from_numpy(x), torch.from_numpy(packed),
             torch.from_numpy(scales), 0, 4)
        assert torch.equal(
            TK.quantized_matmul_w4a8_stacked_persistent(
                *t, act_scale=torch.from_numpy(act)),
            TK.quantized_matmul_w4a8_stacked(
                *t, act_scale=torch.from_numpy(act)))
        with pytest.raises(IndexError, match="out of range"):
            TK.quantized_matmul_w4a8_stacked_persistent(*t[:3], 2, 4)
        with pytest.raises(TypeError, match="uint8"):
            TK.quantized_matmul_w4a8_stacked_persistent(
                t[0], t[1].to(torch.int8), *t[2:])


class TestBf16MatmulStacked:
    @pytest.mark.parametrize("M,N,K", [(1, 128, 256), (8, 256, 128),
                                       (33, 96, 64), (16, 64, 256),
                                       (17, 64, 256), (65, 32, 128),
                                       (8, 48, 136), (17, 40, 136)])
    def test_matches_pallas_interpret(self, M, N, K):
        rng = np.random.default_rng(320 + M)
        x = rng.normal(size=(M, K)).astype(np.float32)
        W = torch.from_numpy(rng.normal(size=(3, N, K)).astype(np.float32)
                             ).to(torch.bfloat16)
        y = TK.bf16_matmul_stacked(torch.from_numpy(x), W, 1)
        ref = np.asarray(JK.bf16_matmul_stacked(
            jnp.asarray(x), jnp.asarray(W.float().numpy()).astype(
                jnp.bfloat16), jnp.asarray(1, jnp.int32), interpret=True))
        # bf16 x bf16 products are exact in f32; the sums' order differs
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())

    def test_rules(self):
        x = torch.zeros((2, 64))
        with pytest.raises(TypeError, match="bf16"):
            TK.bf16_matmul_stacked(x, torch.zeros((1, 8, 64)), 0)
        with pytest.raises(ValueError, match="shape mismatch"):
            TK.bf16_matmul_stacked(x, torch.zeros((1, 8, 32),
                                                  dtype=torch.bfloat16), 0)
        with pytest.raises(IndexError, match="out of range"):
            TK.bf16_matmul_stacked(x, torch.zeros((1, 8, 64),
                                                  dtype=torch.bfloat16), 1)


@pytest.mark.parametrize("M", [1, 8, 16, 17, 128, 512])
@pytest.mark.parametrize("N,K", [(128, 4096), (4096, 128), (4096, 4096),
                                 (200, 136), (4096, 11008), (128, 11008)])
def test_bf16_stacked_plan(M, N, K):
    # the CUDA kernel's launch plan (csrc/bf16_gemm.cu), on a 132-SM card
    plan = TK._bf16_stacked_plan(M, N, K, sms=132)
    k_steps = -(-K // 64)
    splits, step = plan["splits"], plan["split_steps"]
    if M <= 16:
        assert plan["path"] == "splitk"
        assert M <= plan["cols"] == (8 if M <= 8 else 16)
        tiles = -(-N // 64)
        assert plan["grid"] == (tiles, splits)
        # the grid reaches the card's 132 SMs wherever K allows splits of
        # at least 8 steps (several of these CTAs fit an SM)
        if k_steps // 8 >= -(-132 // tiles):
            assert tiles * splits >= 132
    else:
        assert plan["path"] == "tiled" and plan["cols"] == 128
        tiles = -(-N // 128) * -(-M // 128)
        assert plan["grid"] == (-(-N // 128), -(-M // 128), splits)
        # one 192 KB CTA per SM: split only while the grid fits one wave
        assert splits == 1 or tiles * splits <= 132
    # every split is non-empty and together they cover the K steps exactly
    spans = [(i * step, min((i + 1) * step, k_steps)) for i in range(splits)]
    assert all(b > a for a, b in spans) and spans[-1][1] == k_steps
    # no split but the last walks fewer than two 4-stage rings of steps, so
    # a K of under 16 steps (the L shape's 2) is not split
    assert splits == 1 or step >= 8
    if k_steps < 16:
        assert splits == 1
    assert plan["workspace"] == (
        splits * tiles * plan["rows"] * plan["cols"] if splits > 1 else 0)


class _Count:
    """Counts the port's calls of the grid and persistent W4A8 wrappers
    (their launch counters move only on the card)."""

    def __init__(self, monkeypatch):
        self.n = {"grid": 0, "persistent": 0}
        for key, name in (("grid", "quantized_matmul_w4a8_stacked"),
                          ("persistent",
                           "quantized_matmul_w4a8_stacked_persistent")):
            monkeypatch.setattr(TK, name, self._wrap(key, getattr(TK, name)))

    def _wrap(self, key, fn):
        def counted(*args, **kw):
            self.n[key] += 1
            return fn(*args, **kw)
        return counted

    def take(self):
        out, self.n = dict(self.n), {"grid": 0, "persistent": 0}
        return out


class TestProjKernelStep:
    def test_greedy_loop_matches_reference(self):
        # proj_kernel="persistent" on both sides, each step held to the
        # tight bound after the rounding replay
        _loop_over_seeds("tiny-mha", range(2), "i8", staged_kv="uniform",
                         proj_kernel="persistent", steps=4)

    @pytest.mark.parametrize("name,flags,per_layer", [
        # o and down take the persistent launch; qkv and gate/up the grid
        ("tiny-mha", dict(staged_kv="uniform", attn_dots="i8"),
         dict(grid=2, persistent=2)),
        ("tiny", dict(staged_kv=False, attn_dots="f32"),
         dict(grid=2, persistent=2)),
        # "l" takes the L-fused kernel for o and down and ignores the flag
        ("tiny-mha-l", dict(staged_kv="uniform", attn_dots="i8"),
         dict(grid=0, persistent=0)),
        # "lr": qkv and gate/up on the LR kernel; down inside the MLP kernel
        # or o inside the attention kernel leaves the other one persistent
        ("tiny-mha-lr", dict(staged_kv=True, attn_dots="f32",
                             mlp_kernel=True),
         dict(grid=0, persistent=1)),
        ("tiny-mha-lr", dict(staged_kv=True, attn_dots="f32",
                             attn_o_kernel=True),
         dict(grid=0, persistent=1))])
    def test_equals_grid_step(self, monkeypatch, name, flags, per_layer):
        # the same logits, greedy tokens and cache bit for bit as the grid
        # launch, and the projections each option routes to the persistent
        # launch
        config, _, tparams = _params(name)
        pconfig = _port_config(config)
        count = _Count(monkeypatch)
        rng = np.random.default_rng(330)
        B, T = 2, 16

        def run(proj_kernel):
            cache = TL.HeadMajorQuantKVCache.create(pconfig, B, T,
                                                    device="cpu")
            tok = torch.from_numpy(rng.integers(
                0, config.vocab_size, B).astype(np.int64))
            out = []
            for step in range(3):
                pos = torch.full((B,), step, dtype=torch.int32)
                logits, cache = TF.decode_step_fused(
                    tparams, tok, pos, cache, pconfig,
                    proj_kernel=proj_kernel, **flags)
                out.append((logits, count.take()))
                tok = logits.argmax(-1)
            return out, cache

        state = rng.bit_generator.state
        pers, cp = run("persistent")
        rng.bit_generator.state = state
        grid, cg = run("grid")
        L = config.num_layers
        for (lp, np_), (lg, ng) in zip(pers, grid):
            assert torch.equal(lp, lg)
            assert np_ == {k: n * L for k, n in per_layer.items()}
            assert ng == {"grid": (per_layer["grid"]
                                   + per_layer["persistent"]) * L,
                          "persistent": 0}
        for f in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(getattr(cp, f), getattr(cg, f))

    def test_prefill_accepts_and_ignores_the_flag(self, monkeypatch):
        # as the reference: its prefill runs o and down on the grid kernel
        config, _, tparams = _params("tiny-mha")
        pconfig = _port_config(config)
        count = _Count(monkeypatch)
        prompt = np.random.default_rng(340).integers(
            0, config.vocab_size, (1, 9)).astype(np.int64)
        outs = []
        for pk in ("persistent", "grid"):
            cache = TL.HeadMajorQuantKVCache.create(pconfig, 1, 16,
                                                    device="cpu")
            logits, cache = TF.prefill_into_slot_fused(
                tparams, torch.from_numpy(prompt), 0, cache, pconfig,
                proj_kernel=pk)
            outs.append((logits, cache, count.take()))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1].k, outs[1][1].k)
        assert outs[0][2] == outs[1][2] == {
            "grid": 4 * config.num_layers, "persistent": 0}
        # the reference's signature has the flag (its jit does not mark it
        # static, so it cannot be passed there) and its body never reads it
        assert "proj_kernel" in inspect.signature(
            JF.prefill_into_slot_fused).parameters
        with pytest.raises(ValueError, match="proj_kernel"):
            TF.prefill_into_slot_fused(
                tparams, torch.from_numpy(prompt), 0, outs[0][1], pconfig,
                proj_kernel="tiles")
