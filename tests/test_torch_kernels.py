"""PyTorch port, ``ops/kernels.py``: W4A8 stacked and int8 matmuls, packing
and activation quantization against the JAX reference (Pallas kernels in
interpret mode and their XLA twins), plus the port's import hygiene.

Inputs are made with numpy from a seed and handed to both packages."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ee274_convexcaldera_llm_quantization_tpu.ops import kernels as JK
from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels as TK

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "ee274_convexcaldera_llm_quantization_tpu_torch"


def _rng(seed):
    return np.random.default_rng(seed)


def _packed_codes(rng, shape, bits):
    # 8-bit offset-binary codes live in [0, 2 * maxq] = [0, 254]
    high = 255 if bits == 8 else 256
    return rng.integers(0, high, size=shape, dtype=np.uint8)


def _assert_matmul_close(y, ref):
    # i32 sums are exact on both sides; only the f32 rescale may round
    # differently, so the bound is f32 rounding of the output.
    ref = np.asarray(ref)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


class TestW4A8Stacked:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    @pytest.mark.parametrize("M", [1, 8, 33])
    def test_matches_pallas_and_xla(self, bits, M):
        rng = _rng(100 + bits * 7 + M)
        Lk, N, K = 3, 128, 256
        f = 8 // bits
        x = rng.normal(size=(M, K)).astype(np.float32)
        packed = _packed_codes(rng, (Lk, N, K // f), bits)
        scales = rng.uniform(0.001, 0.02, size=(Lk, N, 1)).astype(np.float32)
        layer = 1
        y = TK.quantized_matmul_w4a8_stacked(
            torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(scales), layer, bits)
        ref = JK.quantized_matmul_w4a8_stacked(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
            jnp.asarray(layer, jnp.int32), bits, interpret=True)
        _assert_matmul_close(y, ref)
        twin = JK.quantized_matmul_w4a8_xla(
            jnp.asarray(x), jnp.asarray(packed[layer]),
            jnp.asarray(scales[layer]), bits)
        _assert_matmul_close(y, twin)
        port_twin = TK.quantized_matmul_w4a8_xla(
            torch.from_numpy(x), torch.from_numpy(packed[layer]),
            torch.from_numpy(scales[layer]), bits)
        _assert_matmul_close(port_twin, twin)

    def test_act_scale_overrides_row_absmax(self):
        rng = _rng(5)
        x = rng.normal(size=(4, 128)).astype(np.float32)
        packed = _packed_codes(rng, (2, 64, 64), 4)
        scales = rng.uniform(0.001, 0.02, size=(2, 64, 1)).astype(np.float32)
        act = np.full((4, 1), np.abs(x).max() / 127.0, np.float32)
        y = TK.quantized_matmul_w4a8_stacked(
            torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(scales), 0, 4, act_scale=torch.from_numpy(act))
        ref = JK.quantized_matmul_w4a8_stacked(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
            jnp.asarray(0, jnp.int32), 4, interpret=True,
            act_scale=jnp.asarray(act))
        _assert_matmul_close(y, ref)

    def test_rejects_signed_container(self):
        x = torch.zeros(2, 64)
        packed = torch.zeros(1, 8, 32, dtype=torch.int8)
        with pytest.raises(TypeError, match="uint8"):
            TK.quantized_matmul_w4a8_stacked(x, packed, torch.ones(1, 8, 1),
                                             0, 4)


class TestInt8Matmul:
    @pytest.mark.parametrize("M", [1, 8, 33])
    def test_matches_pallas_and_xla(self, M):
        rng = _rng(200 + M)
        N, K = 256, 128
        x = rng.normal(size=(M, K)).astype(np.float32)
        w8 = rng.integers(-127, 128, size=(N, K), dtype=np.int8)
        scales = rng.uniform(0.001, 0.02, size=(N, 1)).astype(np.float32)
        y = TK.int8_matmul(torch.from_numpy(x), torch.from_numpy(w8),
                           torch.from_numpy(scales))
        ref = JK.int8_matmul(jnp.asarray(x), jnp.asarray(w8),
                             jnp.asarray(scales), interpret=True)
        _assert_matmul_close(y, ref)
        twin = JK.int8_matmul_xla(jnp.asarray(x), jnp.asarray(w8),
                                  jnp.asarray(scales))
        _assert_matmul_close(y, twin)
        port_twin = TK.int8_matmul_xla(torch.from_numpy(x),
                                       torch.from_numpy(w8),
                                       torch.from_numpy(scales))
        _assert_matmul_close(port_twin, twin)

    @pytest.mark.parametrize("N", [200, 300])
    @pytest.mark.parametrize("M", [17, 40, 130])
    def test_matches_pallas_and_xla_above_decode_m(self, M, N):
        # the M of the card's tile path (swapped up to 64, 128-row tiles
        # above), N ragged against its 128-row weight tiles
        rng = _rng(250 + M + N)
        K = 256
        x = rng.normal(size=(M, K)).astype(np.float32)
        w8 = rng.integers(-127, 128, size=(N, K), dtype=np.int8)
        scales = rng.uniform(0.001, 0.02, size=(N, 1)).astype(np.float32)
        y = TK.int8_matmul(torch.from_numpy(x), torch.from_numpy(w8),
                           torch.from_numpy(scales))
        ref = JK.int8_matmul(jnp.asarray(x), jnp.asarray(w8),
                             jnp.asarray(scales), interpret=True)
        _assert_matmul_close(y, ref)
        twin = JK.int8_matmul_xla(jnp.asarray(x), jnp.asarray(w8),
                                  jnp.asarray(scales))
        _assert_matmul_close(y, twin)


class TestPacking:
    @pytest.mark.parametrize("bits", [2, 3, 4, 8])
    def test_pack_rowscale_bytes_equal(self, bits):
        W = _rng(300 + bits).normal(size=(64, 256)).astype(np.float32)
        packed, scales = TK.pack_rowscale(torch.from_numpy(W), bits)
        jp, js = JK.pack_rowscale(jnp.asarray(W), bits)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
        np.testing.assert_allclose(scales.numpy(), np.asarray(js), rtol=1e-7)

    def test_quantize_int8_rowwise_equal(self):
        W = _rng(7).normal(size=(3, 32, 96)).astype(np.float32)
        codes, scales = TK.quantize_int8_rowwise(torch.from_numpy(W))
        jc, js = JK.quantize_int8_rowwise(jnp.asarray(W))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
        np.testing.assert_allclose(scales.numpy(), np.asarray(js), rtol=1e-7)

    @pytest.mark.parametrize("given_scale", [False, True])
    def test_quantize_activations_equal(self, given_scale):
        x = _rng(8).normal(size=(5, 200)).astype(np.float32)
        x[2] = 0.0                                    # absmax floor row
        scale = (np.full((5, 1), 0.02, np.float32) if given_scale else None)
        xq, sx = TK.quantize_activations_int8(
            torch.from_numpy(x),
            None if scale is None else torch.from_numpy(scale))
        jq, js = JK.quantize_activations_int8(
            jnp.asarray(x), None if scale is None else jnp.asarray(scale))
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(sx.numpy(), np.asarray(js), rtol=1e-7)

    def test_container_bits_and_resolve_group(self):
        for b in (2, 3, 4, 8):
            assert TK.container_bits(b) == JK.container_bits(b)
        for bits, K, g in [(4, 4096, None), (2, 11008, None), (4, 96, None),
                           (4, 256, 64)]:
            assert TK.resolve_group(bits, K, g) == JK.resolve_group(bits, K, g)
        with pytest.raises(ValueError):
            TK.container_bits(5)
        with pytest.raises(ValueError):
            TK.resolve_group(4, 256, 48)

    @pytest.mark.parametrize("int8_factors", [False, True])
    def test_low_rank_matmul(self, int8_factors):
        rng = _rng(9)
        x = rng.normal(size=(8, 128)).astype(np.float32)
        L = (rng.normal(size=(64, 16)) * 0.02).astype(np.float32)
        R = (rng.normal(size=(16, 128)) * 0.02).astype(np.float32)
        jL = jnp.asarray(L, jnp.bfloat16)
        jR = jnp.asarray(R, jnp.bfloat16)
        jLs = jRs = None
        if int8_factors:
            jL, jLs = JK.quantize_int8_rowwise(jL)
            jR, jRs = JK.quantize_int8_rowwise(jR)
        ref = np.asarray(JK.low_rank_matmul(jnp.asarray(x), jL, jR, jLs, jRs))

        def t(a):
            if a is None:
                return None
            a = np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                           else a)
            return torch.from_numpy(a)
        tL, tR = t(jL), t(jR)
        if not int8_factors:
            tL, tR = tL.to(torch.bfloat16), tR.to(torch.bfloat16)
        y = TK.low_rank_matmul(torch.from_numpy(x), tL, tR, t(jLs), t(jRs))
        # f32 dots summed in another order: a few f32 ulps of the output
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())


class TestHygiene:
    def test_import_loads_no_jax(self):
        code = (
            "import sys\n"
            "import ee274_convexcaldera_llm_quantization_tpu_torch.models."
            "fused, ee274_convexcaldera_llm_quantization_tpu_torch.interop, "
            "ee274_convexcaldera_llm_quantization_tpu_torch.bench_params, "
            "ee274_convexcaldera_llm_quantization_tpu_torch.serve."
            "fast_engine, "
            "ee274_convexcaldera_llm_quantization_tpu_torch.cli, "
            "ee274_convexcaldera_llm_quantization_tpu_torch.models.surgery, "
            "ee274_convexcaldera_llm_quantization_tpu_torch.decomp.caldera, "
            "ee274_convexcaldera_llm_quantization_tpu_torch.ops.lattice, "
            "ee274_convexcaldera_llm_quantization_tpu_torch.utils."
            "checkpoint, "
            "ee274_convexcaldera_llm_quantization_tpu_torch.calibrate."
            "hessian\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or "
            "m.startswith('ee274_convexcaldera_llm_quantization_tpu.') or "
            "m == 'ee274_convexcaldera_llm_quantization_tpu')\n"
            "assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr

    def test_sources_import_nothing_of_jax(self):
        files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
        bad_jax = re.compile(r"^\s*(import|from)\s+jax(lib)?\b", re.M)
        bad_pkg = re.compile(
            r"((import|from)\s+|import_module\(\s*['\"])"
            r"ee274_convexcaldera_llm_quantization_tpu(?!_torch)\b")
        for path in files:
            text = path.read_text()
            assert not bad_jax.search(text), path
            assert not bad_pkg.search(text), path
