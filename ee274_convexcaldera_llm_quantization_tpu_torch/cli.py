"""Command line: ``compress | calibrate | eval | serve``, in PyTorch.

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.cli``: the same
subcommands, flags and JSON result lines, on the port. Run as

    python -m ee274_convexcaldera_llm_quantization_tpu_torch.cli compress \\
        --model tiny --serving-mode w4a8 --output ckpt

``--model`` names a preset or a local Hugging Face checkpoint directory
(``models.hf_import``). Every subcommand runs on ``--device`` (``cuda`` by
default, which raises without a card; ``--device cpu`` runs the plain
PyTorch versions of the kernels). Not ported yet: ``bench`` (the port
bench, ROADMAP.md Queue A item 7), which raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def _add_model_args(p):
    p.add_argument("--model", default="tiny", help="preset name or HF dir")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory of model params")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda by default; cpu runs the plain "
                        "versions of the kernels)")


def _load_model(args):
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import llama
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.config import (
        PRESETS)
    if args.checkpoint:
        from ee274_convexcaldera_llm_quantization_tpu_torch.utils.checkpoint \
            import load_params
        return load_params(args.checkpoint, device=args.device)
    if args.model in PRESETS:
        config = PRESETS[args.model]
        return llama.init_params(args.seed, config, device=args.device), config
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.hf_import \
        import load_hf_checkpoint
    return load_hf_checkpoint(args.model, device=args.device)


def cmd_compress(args):
    from ee274_convexcaldera_llm_quantization_tpu_torch.calibrate.hessian \
        import load_hessians
    from ee274_convexcaldera_llm_quantization_tpu_torch.decomp.caldera import (
        CalderaParams)
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.surgery import (
        compress_model, compress_model_batched)
    from ee274_convexcaldera_llm_quantization_tpu_torch.quant.quantizers \
        import QuantizerFactory

    params, config = _load_model(args)
    hessians = load_hessians(args.hessians) if args.hessians else None
    cp = CalderaParams(Q_bits=args.q_bits, L_bits=args.l_bits,
                       R_bits=args.r_bits, rank=args.rank, iters=args.iters,
                       lplr_iters=args.lplr_iters, q_update=args.q_update)
    if args.serving_quant == "e8p":
        cp = dataclasses.replace(cp, quant_factory_Q=QuantizerFactory(
            method="e8p", block_size="global"))
    layer_range = None
    if args.layers:
        lo, hi = args.layers.split("-")
        layer_range = (int(lo), int(hi))
    extra = {}
    if not args.batched:
        extra["serving_quant"] = args.serving_quant
    elif args.serving_quant != "uniform":
        raise SystemExit("--serving-quant e8p requires the serial "
                         "(non --batched) compressor")
    t0 = time.time()
    fn = compress_model_batched if args.batched else compress_model
    qparams, report = fn(
        params, cp, hessians=hessians, layer_range=layer_range,
        error_threshold=args.error_threshold,
        serving_mode=args.serving_mode, **extra,
        progress=lambda n, e: print(f"  {n}: rel_err={e:.4f}",
                                    file=sys.stderr))
    print(json.dumps({
        "compressed": len(report.compressed),
        "skipped": len(report.skipped),
        "avg_bits_per_param": round(report.avg_bits_per_param, 4),
        "max_rel_error": round(max(report.errors.values(), default=0.0), 4),
        "seconds": round(time.time() - t0, 1),
    }))
    if args.output:
        from ee274_convexcaldera_llm_quantization_tpu_torch.utils.checkpoint \
            import save_params
        save_params(args.output, qparams, config)
        print(f"saved compressed model to {args.output}", file=sys.stderr)
    return qparams, report


def cmd_eval(args):
    from ee274_convexcaldera_llm_quantization_tpu_torch.evalm.perplexity \
        import evaluate_perplexity

    params, config = _load_model(args)
    if args.tokens:
        stream = np.load(args.tokens)
    else:
        stream = np.random.default_rng(0).integers(
            0, config.vocab_size, size=args.synthetic_tokens)
    ppl = evaluate_perplexity(params, stream, config, window=args.window,
                              batch_size=args.batch_size, device=args.device)
    print(json.dumps({"perplexity": round(ppl, 4), "window": args.window,
                      "tokens": int(len(stream))}))


def cmd_calibrate(args):
    from ee274_convexcaldera_llm_quantization_tpu_torch.calibrate.hessian \
        import collect_hessians, save_hessians

    params, config = _load_model(args)
    rng = np.random.default_rng(args.seed)
    batches = [rng.integers(0, config.vocab_size,
                            size=(args.batch_size, args.window))
               for _ in range(args.num_batches)]
    hs = collect_hessians(params, batches, config, diag=not args.full)
    save_hessians(args.output, hs)
    print(json.dumps({"layers": len(hs), "output": args.output}))


def _all_w4a8(params) -> bool:
    from ee274_convexcaldera_llm_quantization_tpu_torch.models.compressed \
        import CalderaLinear
    return all(isinstance(getattr(lp, name), CalderaLinear)
               and getattr(lp, name).mode == "w4a8"
               for lp in params.layers
               for name in ("q_proj", "k_proj", "v_proj", "o_proj",
                            "gate_proj", "up_proj", "down_proj"))


def _as_fused(params):
    """Stack and fuse a fully w4a8-compressed model; None otherwise."""
    from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
        fused, stacked)
    if not _all_w4a8(params):
        return None
    return fused.quantize_factors_int8_fused(
        fused.fuse_stacked(stacked.stack_layers(params)))


def cmd_serve(args):
    from ee274_convexcaldera_llm_quantization_tpu_torch.serve.engine import (
        Request, ServingEngine)

    params, config = _load_model(args)
    if args.engine == "paged":
        from ee274_convexcaldera_llm_quantization_tpu_torch.serve \
            .paged_engine import PagedServingEngine
        fused = _as_fused(params)
        served_path = "paged-fused" if fused is not None else "paged-bf16"
        eng = PagedServingEngine(
            fused if fused is not None else params, config,
            max_slots=args.max_slots, num_pages=args.num_pages,
            page_size=args.page_size,
            max_pages_per_seq=-(-args.max_seq_len // args.page_size),
            device=args.device)
        print(json.dumps({"path": served_path}), file=sys.stderr,
              flush=True)
    elif args.engine == "fast":
        from ee274_convexcaldera_llm_quantization_tpu_torch.models import (
            stacked)
        from ee274_convexcaldera_llm_quantization_tpu_torch.serve \
            .fast_engine import FastServingEngine
        if not _all_w4a8(params):
            raise SystemExit("--engine fast requires a fully-w4a8 "
                             "compressed model (compress --serving-mode "
                             "w4a8)")
        eng = FastServingEngine(stacked.stack_layers(params), config,
                                max_slots=args.max_slots,
                                max_seq_len=args.max_seq_len,
                                device=args.device)
    else:
        eng = ServingEngine(params, config, max_slots=args.max_slots,
                            max_seq_len=args.max_seq_len, device=args.device)
    if args.http_port is not None:
        from ee274_convexcaldera_llm_quantization_tpu_torch.serve \
            .http_server import ServingHTTPServer
        srv = ServingHTTPServer(eng, host=args.http_host,
                                port=args.http_port)
        print(json.dumps({"serving": f"http://{srv.host}:{srv.port}",
                          "endpoints": ["/health", "/v1/stats",
                                        "/v1/completions"]}), flush=True)
        srv.serve_forever()
        return
    rng = np.random.default_rng(0)
    t0 = time.time()
    for uid in range(args.num_requests):
        eng.submit(Request(
            uid=uid,
            prompt=rng.integers(0, config.vocab_size, size=args.prompt_len),
            max_new_tokens=args.max_new_tokens))
    done = eng.run()
    dt = time.time() - t0
    total = sum(len(c.tokens) for c in done)
    print(json.dumps({"requests": len(done), "tokens": total,
                      "tokens_per_s": round(total / dt, 2),
                      "seconds": round(dt, 2),
                      "path": (served_path if args.engine == "paged"
                               else args.engine)}))


def cmd_bench(args):
    raise NotImplementedError(
        "the port's benchmark is not written yet (ROADMAP.md, Queue A "
        "item 7)")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ccq-torch",
        description="CALDERA / Convex-CALDERA framework, PyTorch port")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compress", help="CALDERA-compress a model")
    _add_model_args(p)
    p.add_argument("--q-bits", type=int, default=2)
    p.add_argument("--l-bits", type=int, default=16)
    p.add_argument("--r-bits", type=int, default=16)
    p.add_argument("--rank", type=int, default=128)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--lplr-iters", type=int, default=5)
    p.add_argument("--hessians", default=None,
                   help="npz or reference diag_Hessians.pt")
    p.add_argument("--layers", default=None,
                   help="inclusive range, e.g. 17-23")
    p.add_argument("--error-threshold", type=float, default=0.99)
    p.add_argument("--serving-mode", default="grouped",
                   choices=["grouped", "w4a8"])
    p.add_argument("--q-update", default="rtn", choices=["rtn", "ldlq"],
                   help="Q-update rule: round-to-nearest or LDLQ error "
                        "feedback")
    p.add_argument("--serving-quant", default="uniform",
                   choices=["uniform", "e8p"],
                   help="e8p: 2-bit E8 lattice codebook served via the "
                        "int4 repack (needs --serving-mode w4a8)")
    p.add_argument("--batched", action="store_true",
                   help="solve each projection type's layers as one stack")
    p.add_argument("--output", default=None)
    p.set_defaults(func=cmd_compress)

    p = sub.add_parser("eval", help="perplexity eval")
    _add_model_args(p)
    p.add_argument("--tokens", default=None, help="npy token stream")
    p.add_argument("--synthetic-tokens", type=int, default=8192)
    p.add_argument("--window", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=1)
    p.set_defaults(func=cmd_eval)

    p = sub.add_parser("calibrate", help="collect Hessians")
    _add_model_args(p)
    p.add_argument("--num-batches", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--window", type=int, default=128)
    p.add_argument("--full", action="store_true", help="full (not diag) H")
    p.add_argument("--output", required=True)
    p.set_defaults(func=cmd_calibrate)

    p = sub.add_parser("serve", help="continuous-batching smoke serve")
    _add_model_args(p)
    p.add_argument("--max-slots", type=int, default=4)
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--num-requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--engine", default="slotted",
                   choices=["slotted", "paged", "fast"])
    p.add_argument("--num-pages", type=int, default=256)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--http-port", type=int, default=None,
                   help="serve a JSON HTTP API on this port instead of the "
                        "synthetic smoke run (0 = ephemeral)")
    p.add_argument("--http-host", default="127.0.0.1")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("bench", help="the port's benchmark (not ported)")
    p.add_argument("--model", default="llama2-7b")
    p.add_argument("--extra", default=None)
    p.set_defaults(func=cmd_bench)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
