"""The ranks' side of ``tests/test_torch_parallel.py`` and
``tests/test_torch_pp.py``: one function per spawned world, run on every
rank by ``parallel.bootstrap.launch`` over gloo on the CPU, each running all
of its world's cases in one spawn and returning numpy results.

This module imports the port and torch only, never JAX: the spawned ranks
import it by name, and the reference runs in the pytest process.
"""

import dataclasses

import numpy as np
import torch

from ee274_convexcaldera_llm_quantization_tpu_torch import bench_params
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    fused, llama, stacked, train)
from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
    config as TC)
from ee274_convexcaldera_llm_quantization_tpu_torch.parallel import (
    comm, mesh as pm, pp as PP, tp_decode as TPD, tp_fused as TPF,
    tp_kernels as TPK)
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import paged
from ee274_convexcaldera_llm_quantization_tpu_torch.serve import (
    engine as TE, fast_engine as TFE, tp_engine as TTE)


def _np(t):
    """A tensor as numpy (bf16 values widened to f32, exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _caches(cache):
    return {f.name: _np(getattr(cache, f.name))
            for f in dataclasses.fields(cache)}


def _copy(cache):
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).clone()
        for f in dataclasses.fields(cache)})


def _code_diff(a, b):
    """Differing K/V codes of two caches (or pools) of equal shape."""
    return int((a.k != b.k).sum() + (a.v != b.v).sum())


def _scale_rel(a, b):
    return max(float(((getattr(a, n) - getattr(b, n)).abs()
                      / getattr(b, n).abs().clamp_min(1e-30)).max())
               for n in ("k_scale", "v_scale"))


def _serve(engine, reqs):
    for uid, prompt, new in reqs:
        engine.submit(TE.Request(uid=uid, prompt=prompt,
                                 max_new_tokens=new))
    return {c.uid: list(c.tokens) for c in engine.run()}


def _pp_mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(shape))
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


# ---------------------------------------------------------------------------
# The world of two ranks (tests/test_torch_parallel.py)
# ---------------------------------------------------------------------------

def _fused_step(fp, cfg, mesh):
    """One TP step from the empty cache (the reference test's inputs)
    against the single-device step."""
    toks, pos = torch.tensor([1, 2]), torch.tensor([3, 5], dtype=torch.int32)
    c1 = llama.HeadMajorQuantKVCache.create(cfg, 2, 16, device="cpu")
    ref, c1 = fused.decode_step_fused(fp, toks, pos, c1, cfg,
                                      staged_kv="uniform")
    c2 = TPF.shard_headmajor_cache_tp(
        llama.HeadMajorQuantKVCache.create(cfg, 2, 16, device="cpu"), mesh)
    got, c2 = TPF.decode_step_fused_tp(TPF.shard_fused_model_tp(fp, mesh),
                                       toks, pos, c2, cfg, mesh)
    local = TPF.shard_headmajor_cache_tp(c1, mesh)
    return dict(tp=_np(got), single=_np(ref), codes=_code_diff(c2, local),
                scale_rel=_scale_rel(c2, local), cache=_caches(c2))


def _fused_vs_single(fp, cfg, mesh, inp):
    """(a) one step from the empty cache (:func:`_fused_step`); (b) a
    6-token prefill, flash and plain, then 3 greedy steps, each TP step
    from the single-device step's cache; (c) the same 3 steps left to run
    free."""
    out = dict(step=_fused_step(fp, cfg, mesh))
    tpp = TPF.shard_fused_model_tp(fp, mesh)
    prompt = torch.from_numpy(inp["prompt"])[None]
    for flash in (False, True):
        cs = llama.HeadMajorQuantKVCache.create(cfg, 1, 16, device="cpu")
        ls, cs = fused.prefill_into_slot_fused(fp, prompt, 0, cs, cfg,
                                               flash=flash)
        ct = TPF.shard_headmajor_cache_tp(
            llama.HeadMajorQuantKVCache.create(cfg, 1, 16, device="cpu"),
            mesh)
        lt, ct = TPF.prefill_into_slot_fused_tp(tpp, prompt, 0, ct, cfg,
                                                mesh, flash=flash)
        rows = [dict(logits=float((lt - ls).abs().max()),
                     codes=_code_diff(ct, TPF.shard_headmajor_cache_tp(
                         cs, mesh)))]
        free_t = _copy(ct)
        seq_s, seq_t = [int(ls.argmax())], [int(lt.argmax())]
        p = prompt.shape[1]
        for step in range(3):
            tok = torch.tensor([seq_s[-1]])
            pos = torch.tensor([p + step], dtype=torch.int32)
            ct = TPF.shard_headmajor_cache_tp(cs, mesh)
            ls, cs = fused.decode_step_fused(fp, tok, pos, cs, cfg,
                                             staged_kv="uniform")
            lt, ct = TPF.decode_step_fused_tp(tpp, tok, pos, ct, cfg, mesh)
            rows.append(dict(logits=float((lt - ls).abs().max()),
                             codes=_code_diff(ct, TPF.shard_headmajor_cache_tp(
                                 cs, mesh))))
            seq_s.append(int(ls[0].argmax()))
            lf, free_t = TPF.decode_step_fused_tp(
                tpp, torch.tensor([seq_t[-1]]), pos, free_t, cfg, mesh)
            seq_t.append(int(lf[0].argmax()))
        out[f"prefill_decode_flash{int(flash)}"] = dict(
            rows=rows, single=seq_s, tp=seq_t)
    return out


# A rounding flip (tests/test_torch_fused.py): values before rounding
# within this share of a code, codes one apart, at most this many a step.
FLIP_RATIO_TOL, MAX_FLIPS = 5e-2, 16


def _replayed(step, refs, group, pipeline=False):
    """Run the collective ``step()`` (which must start from the same state
    each call) until every int8 activation code of this rank equals the
    reference's: ``refs[rank]`` is the reference's record of this rank's
    shard, one ``(codes, x / scale)`` per ``quantize_activations_int8`` call.
    Each round the ranks agree on the first call where any rank differs,
    and each rank that differs there takes the reference's codes at it
    (each must be a rounding flip). Under ``pipeline`` (the group's ranks
    are stages, each stage's calls following the earlier stages') only the
    first stage that differs takes the reference's codes, at its first
    differing call. Returns (output before, output after, codes replayed on
    this rank, the largest flip's value difference)."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels
    ref = refs[comm.group_rank(group)]
    orig = kernels.quantize_activations_int8
    seen, force = [], {}

    def wrapped(x, scale=None):
        codes, sc = orig(x, scale)
        i = len(seen)
        if i in force:
            m, c = force[i]
            codes = torch.where(torch.from_numpy(m), torch.from_numpy(c),
                                codes)
        seen.append((codes.numpy().copy(), (x.float() / sc).numpy()))
        return codes, sc

    kernels.quantize_activations_int8 = wrapped
    first = None
    flips, worst = 0, 0.0
    try:
        while True:
            seen.clear()
            out = step()
            if first is None:
                first = out
            assert len(seen) == len(ref) > 0, (len(seen), len(ref))
            at = next((i for i, ((c, _), (rc, _)) in enumerate(zip(seen, ref))
                       if not np.array_equal(c, rc)), len(ref))
            if pipeline:
                me, n = comm.group_rank(group), comm.group_size(group)
                t = comm.all_max(torch.tensor(
                    [float(n - me if at < len(ref) else 0)]), group)
                if int(t[0]) == 0:
                    break
                fix = n - int(t[0]) == me
            else:
                t = comm.all_max(torch.tensor([float(len(ref) - at)]), group)
                at_all = len(ref) - int(t[0])
                if at_all == len(ref):
                    break
                fix = at == at_all
            if fix:
                (c, r), (rc, rr) = seen[at], ref[at]
                m = c != rc
                assert np.abs(c[m].astype(np.int32) - rc[m]).max() == 1, at
                worst = max(worst, float(np.abs(r[m] - rr[m]).max()))
                assert worst <= FLIP_RATIO_TOL, (at, worst)
                force[at] = (m, rc)
                flips += int(m.sum())
                assert flips <= MAX_FLIPS, flips
    finally:
        kernels.quantize_activations_int8 = orig
    return first, out, flips, worst


def _stacked_tp(sp, cfg, mesh, inp):
    """The stacked TP step on the bf16 and int8 caches (each int8
    activation rounding replayed to the reference's), and the prefill."""
    out = {}
    group = comm.axis_group(mesh, "tp")
    tpp = TPD.shard_stacked_model_tp(sp, mesh)
    toks, pos = torch.tensor([1, 2]), torch.tensor([3, 5], dtype=torch.int32)
    for name, cls in (("bf16", llama.KVCache), ("quant", llama.QuantKVCache)):
        def step():
            c = TPD.shard_kv_cache_tp(cls.create(cfg, 2, 16, device="cpu"),
                                      mesh)
            logits, c = TPD.decode_step_w4a8_tp(tpp, toks, pos, c, cfg, mesh)
            return _np(logits), _caches(c)
        (before, _), (logits, cache), flips, worst = _replayed(
            step, inp["stacked_ref"][name], group)
        out[f"decode_{name}"] = dict(logits=logits, cache=cache,
                                     before=before, flips=flips, worst=worst)
    c = TPD.shard_kv_cache_tp(llama.KVCache.create(cfg, 1, 16, device="cpu"),
                              mesh)
    logits, c = TPD.prefill_into_slot_w4a8_tp(
        tpp, torch.from_numpy(inp["prompt"])[None], 0, c, cfg, mesh,
        last_pos=4)
    out["prefill"] = dict(logits=_np(logits), cache=_caches(c))
    return out


def _paged_tp(fp, cfg, mesh, inp):
    """Two 7-token prompts through the paged TP prefill, one paged TP step,
    each against the single-device paged functions; the active mask."""
    tpp = TPF.shard_fused_model_tp(fp, mesh)
    prompts = torch.from_numpy(inp["paged_prompts"])
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    pool_s = paged.PagedQuantKVPool.create(cfg, 5, 16, device="cpu")
    pool_t = TPF.shard_paged_pool_tp(
        paged.PagedQuantKVPool.create(cfg, 5, 16, device="cpu"), mesh)
    pre = []
    for b in range(2):
        ls, pool_s = paged.paged_prefill_fused(fp, prompts[b:b + 1], pool_s,
                                               tables[b], cfg)
        lt, pool_t = TPF.paged_prefill_fused_tp(tpp, prompts[b:b + 1],
                                                pool_t, tables[b], cfg, mesh)
        pre.append(dict(tp=_np(lt), single=_np(ls)))
    prefill_codes = _code_diff(pool_t, TPF.shard_paged_pool_tp(pool_s, mesh))
    toks = torch.from_numpy(inp["paged_tokens"])
    pos = torch.full((2,), 7, dtype=torch.int32)
    ls, pool_s = paged.paged_decode_step_fused(fp, toks, pos, pool_s, tables,
                                               cfg)
    lt, pool_t = TPF.paged_decode_step_fused_tp(tpp, toks, pos, pool_t,
                                                tables, cfg, mesh)
    act = TPF.shard_paged_pool_tp(
        paged.PagedQuantKVPool.create(cfg, 5, 16, device="cpu"), mesh)
    la, act = TPF.paged_decode_step_fused_tp(
        tpp, torch.tensor([1, 2]), torch.tensor([3, 0], dtype=torch.int32),
        act, tables, cfg, mesh, active=torch.tensor([True, False]),
        scratch_page=4)
    return dict(prefill=pre, prefill_codes=prefill_codes,
                decode=dict(tp=_np(lt), single=_np(ls),
                            codes=_code_diff(
                                pool_t, TPF.shard_paged_pool_tp(pool_s,
                                                                mesh))),
                active=dict(logits=_np(la), scratch=_np(act.k_scale[:, 4]),
                            untouched=_np(act.k_scale[:, 2:4])))


def _pp2(fp, sp, cfg, inp):
    """pp=2 against the single-device fused and stacked steps; the stacked
    step also replayed to the reference's roundings."""
    mesh = _pp_mesh((2,), ("pp",))
    toks = torch.tensor([1, 2, 3, 4])
    pos = torch.tensor([3, 5, 2, 7], dtype=torch.int32)
    out = {}
    c0 = llama.HeadMajorQuantKVCache.create(cfg, 4, 16, device="cpu")
    ref, c0 = fused.decode_step_fused(fp, toks, pos, c0, cfg, staged_kv=True)
    c1 = PP.shard_kv_cache_pp(
        llama.HeadMajorQuantKVCache.create(cfg, 4, 16, device="cpu"), mesh)
    got, c1 = PP.decode_step_fused_pp(PP.shard_fused_model_pp(fp, mesh), toks,
                                      pos, c1, cfg, mesh)
    out["fused"] = dict(tp=_np(got), single=_np(ref),
                        codes=_code_diff(c1, PP.shard_kv_cache_pp(c0, mesh)),
                        kv=_caches(c1))
    spp = PP.shard_stacked_model_pp(sp, mesh)
    for name, cls in (("bf16", llama.KVCache), ("quant", llama.QuantKVCache)):
        c0 = cls.create(cfg, 4, 16, device="cpu")
        ref, c0 = stacked.decode_step_w4a8(sp, toks, pos, c0, cfg)

        def step():
            c1 = PP.shard_kv_cache_pp(cls.create(cfg, 4, 16, device="cpu"),
                                      mesh)
            got, c1 = PP.decode_step_w4a8_pp(spp, toks, pos, c1, cfg, mesh)
            return _np(got), c1
        # the step as it runs, then replayed to the reference's roundings
        (got, c1), (replayed, c2), flips, _ = _replayed(
            step, inp["stacked_pp_ref"][f"stacked_{name}"],
            comm.axis_group(mesh, "pp"), pipeline=True)
        local = PP.shard_kv_cache_pp(c0, mesh)
        out[f"stacked_{name}"] = dict(
            tp=got, single=_np(ref), replayed=replayed, flips=flips,
            kv_replayed=_caches(c2),
            cache=max(float((getattr(c1, n).float()
                             - getattr(local, n).float()).abs().max())
                      for n in ("k", "v")))
    return out


def _engines(sp, cfg, mesh, inp):
    """TPServingEngine (fused, flash and plain prefill; stacked) against
    FastServingEngine on the same requests."""
    reqs = [(i, p, 5) for i, p in enumerate(inp["engine_prompts"])]
    out = {}
    fp = TTE._fused_params(sp)
    for flash in (False, True):
        tp = _serve(TTE.TPServingEngine(sp, cfg, mesh, max_slots=2,
                                        max_seq_len=32, flash_attn=flash,
                                        device="cpu"), reqs)
        single = _serve(TFE.FastServingEngine(
            fp, cfg, max_slots=2, max_seq_len=32, flash_attn=True,
            device="cpu"), reqs) if flash else None
        out[f"fused_flash{int(flash)}"] = dict(tp=tp, single=single)
    out["stacked"] = dict(
        tp=_serve(TTE.TPServingEngine(sp, cfg, mesh, max_slots=2,
                                      max_seq_len=32, fused=False,
                                      kv_int8=True, device="cpu"), reqs),
        single=_serve(TFE.FastServingEngine(sp, cfg, max_slots=2,
                                            max_seq_len=32, kv_int8=True,
                                            device="cpu"), reqs))
    return out


def _kernels(mesh, inp):
    """The flat W4A8 kernel column- and row-parallel (tp_kernels)."""
    rank = comm.axis_rank(mesh, "tp")
    W = torch.from_numpy(inp["W"])
    Wr = torch.from_numpy(inp["W_row"])
    x = torch.from_numpy(inp["x"])
    from ee274_convexcaldera_llm_quantization_tpu_torch.ops import kernels
    packed, rs = kernels.pack_rowscale(W, 4)
    n = W.shape[0] // 2
    col = TPK.column_parallel_w4a8(mesh, 4)(
        x, packed[rank * n:(rank + 1) * n], rs[rank * n:(rank + 1) * n])
    pk, srs = TPK.pack_rowscale_sharded(Wr, 4, 2)
    xr = torch.from_numpy(inp["x_row"])
    k = xr.shape[1] // 2
    b = pk.shape[1] // 2
    row = TPK.row_parallel_w4a8(mesh, 4)(
        xr[:, rank * k:(rank + 1) * k], pk[:, rank * b:(rank + 1) * b],
        srs[:, rank:rank + 1])
    return dict(col=_np(comm.gather_last(col, comm.axis_group(mesh, "tp"))),
                col_ref=_np(kernels.quantized_matmul_w4a8(x, packed, rs, 4)),
                row=_np(row))


def _dtensor_forward(cfg, mesh):
    """The catalog's DTensor placements through the plain forward, dense
    and compressed, against the unsharded forward."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.decomp.caldera import (
        CalderaParams)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.surgery import (
        compress_model)
    dense = llama.init_params(0, cfg, device="cpu")
    comp, _ = compress_model(dense, CalderaParams(
        Q_bits=4, L_bits=16, R_bits=16, rank=8, iters=1, lplr_iters=1))
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(7))
    out = {}
    for name, params in (("dense", dense), ("compressed", comp)):
        sharded = pm.shard_params(params, mesh)
        got = llama.forward(sharded, toks, cfg)
        q = sharded.layers[0].q_proj
        w = q.w if hasattr(q, "w") else q.packed
        out[name] = dict(got=_np(got.full_tensor()),
                         ref=_np(llama.forward(params, toks, cfg)),
                         local_q=tuple(w.to_local().shape),
                         placements=str(got.placements))
    return out


def world_tp2(rank, inputs_path):
    """Every case of the two-rank world."""
    torch.manual_seed(0)
    inp = torch.load(inputs_path, weights_only=False)
    cfg, fp, sp = inp["config"], inp["fused"], inp["stacked"]
    mesh = pm.make_mesh(1, 2, device_type="cpu")
    out = dict(rank=rank,
               fused=_fused_vs_single(fp, cfg, mesh, inp),
               factor={name: _fused_step(p, c, mesh)
                       for name, (c, p) in inp["factor_sets"].items()},
               stacked=_stacked_tp(sp, cfg, mesh, inp),
               paged=_paged_tp(fp, cfg, mesh, inp),
               pp2=_pp2(fp, sp, cfg, inp),
               engines=_engines(sp, cfg, mesh, inp),
               kernels=_kernels(mesh, inp),
               dtensor=_dtensor_forward(cfg, mesh))
    return out


# ---------------------------------------------------------------------------
# The world of four ranks (tests/test_torch_pp.py)
# ---------------------------------------------------------------------------

def _tiny_fused(cfg, seed=0):
    sp = bench_params.build_compressed_llama_params(cfg, num_bits=4, rank=16,
                                                    seed=seed, device="cpu")
    return sp, fused.quantize_factors_int8_fused(fused.fuse_stacked(sp))


def _pp4(cfg4):
    """pp=4 on a 4-layer model, fused and stacked."""
    sp, fp = _tiny_fused(cfg4)
    mesh = _pp_mesh((4,), ("pp",))
    toks = torch.tensor([1, 2, 3, 4])
    pos = torch.tensor([3, 5, 2, 7], dtype=torch.int32)
    c0 = llama.HeadMajorQuantKVCache.create(cfg4, 4, 16, device="cpu")
    ref, c0 = fused.decode_step_fused(fp, toks, pos, c0, cfg4, staged_kv=True)
    c1 = PP.shard_kv_cache_pp(
        llama.HeadMajorQuantKVCache.create(cfg4, 4, 16, device="cpu"), mesh)
    got, c1 = PP.decode_step_fused_pp(PP.shard_fused_model_pp(fp, mesh), toks,
                                      pos, c1, cfg4, mesh)
    out = dict(fused=dict(tp=_np(got), single=_np(ref),
                          codes=_code_diff(c1, PP.shard_kv_cache_pp(c0,
                                                                    mesh))))
    c0 = llama.QuantKVCache.create(cfg4, 4, 16, device="cpu")
    ref, c0 = stacked.decode_step_w4a8(sp, toks, pos, c0, cfg4)
    c1 = PP.shard_kv_cache_pp(llama.QuantKVCache.create(cfg4, 4, 16,
                                                        device="cpu"), mesh)
    got, c1 = PP.decode_step_w4a8_pp(PP.shard_stacked_model_pp(sp, mesh),
                                     toks, pos, c1, cfg4, mesh)
    out["stacked"] = dict(tp=_np(got), single=_np(ref),
                          codes=_code_diff(c1, PP.shard_kv_cache_pp(c0,
                                                                    mesh)))
    # three greedy steps through the pipeline against single-device decode
    seqs = {}
    for name in ("single", "pp"):
        c = llama.HeadMajorQuantKVCache.create(cfg4, 4, 16, device="cpu")
        ppp = None
        if name == "pp":
            c = PP.shard_kv_cache_pp(c, mesh)
            ppp = PP.shard_fused_model_pp(fp, mesh)
        t, seq = toks, []
        for step in range(3):
            p = torch.full((4,), step, dtype=torch.int32)
            if ppp is None:
                lg, c = fused.decode_step_fused(fp, t, p, c, cfg4,
                                                staged_kv=True)
            else:
                lg, c = PP.decode_step_fused_pp(ppp, t, p, c, cfg4, mesh)
            t = lg.argmax(-1)
            seq.append(t.tolist())
        seqs[name] = seq
    out["greedy"] = seqs
    return out


def _pp_tp(cfg, fp):
    """pp=2 x tp=2 on the fused step against the single-device step."""
    mesh = _pp_mesh((2, 2), ("pp", "tp"))
    toks = torch.tensor([1, 2, 3, 4])
    pos = torch.tensor([3, 5, 2, 7], dtype=torch.int32)
    c0 = llama.HeadMajorQuantKVCache.create(cfg, 4, 16, device="cpu")
    ref, c0 = fused.decode_step_fused(fp, toks, pos, c0, cfg, staged_kv=True)
    c1 = PP.shard_headmajor_cache_pp_tp(
        llama.HeadMajorQuantKVCache.create(cfg, 4, 16, device="cpu"), mesh)
    got, c1 = PP.decode_step_fused_pp(PP.shard_fused_model_pp_tp(fp, mesh),
                                      toks, pos, c1, cfg, mesh,
                                      tp_axis="tp")
    return dict(tp=_np(got), single=_np(ref), kv=_caches(c1),
                codes=_code_diff(c1, PP.shard_headmajor_cache_pp_tp(c0,
                                                                    mesh)))


def _dp_tp(cfg):
    """dp=2 x tp=2 DTensor placements: the forward on dp-sharded tokens and
    one train step, against the unsharded port."""
    mesh = pm.make_mesh(2, 2, device_type="cpu")
    dense = llama.init_params(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 16),
                         generator=torch.Generator().manual_seed(11))
    sharded = pm.shard_params(dense, mesh)
    st = pm.shard_batch(toks, mesh)
    got = llama.forward(sharded, st, cfg)
    opt = train.make_optimizer(1e-3)
    p1, _, l1 = train.train_step(dense, train.init_train_state(dense, opt),
                                 toks, cfg, opt)
    p2, _, l2 = train.train_step(sharded, train.init_train_state(sharded,
                                                                  opt),
                                 st, cfg, opt)
    return dict(got=_np(got.full_tensor()),
                ref=_np(llama.forward(dense, toks, cfg)),
                loss=float(l1), loss_sharded=float(l2.full_tensor()),
                lr=opt.lr,
                q_after=_np(p2.layers[0].q_proj.w.full_tensor().float()),
                q_after_ref=_np(p1.layers[0].q_proj.w.float()),
                q_before=_np(dense.layers[0].q_proj.w.float()),
                local_q=tuple(sharded.layers[0].q_proj.w.to_local().shape),
                local_tokens=tuple(st.to_local().shape))


def _perplexity(cfg):
    """dp and dp x sp perplexity against the unsharded harness."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.evalm.perplexity import (
        evaluate_perplexity)
    mesh = pm.make_mesh(2, 2, device_type="cpu")
    dense = llama.init_params(0, cfg, device="cpu")
    stream = np.random.default_rng(30).integers(0, cfg.vocab_size,
                                                size=7 * 64)
    kw = dict(window=64, batch_size=4, device="cpu")
    try:
        evaluate_perplexity(dense, stream, cfg, window=64, batch_size=3,
                            mesh=mesh, device="cpu")
        bad = False
    except ValueError:
        bad = True
    return dict(base=evaluate_perplexity(dense, stream, cfg, **kw),
                dp=evaluate_perplexity(dense, stream, cfg, mesh=mesh, **kw),
                sp=evaluate_perplexity(dense, stream, cfg, mesh=mesh,
                                       seq_axis="tp", **kw),
                bad_batch_raises=bad)


def world_4(rank, inputs_path):
    """Every case of the four-rank world (PP x TP on the reference's TINY
    fused params, from ``inputs_path``)."""
    torch.manual_seed(0)
    cfg = TC.TINY
    inp = torch.load(inputs_path, weights_only=False)
    return dict(rank=rank,
                pp4=_pp4(dataclasses.replace(cfg, num_layers=4)),
                pp_tp=_pp_tp(cfg, inp["fused"]), dp_tp=_dp_tp(cfg),
                perplexity=_perplexity(cfg))
