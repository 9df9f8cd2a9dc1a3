"""Serving launcher CLI (port of ``repro/launch/serve.py``): bring up a
hardware-form (serve-phase) model of any registered config (the lm,
hybrid, xlstm and encdec families) and drain a synthetic request stream
through a slot engine (continuous or paged, optionally with speculative
decoding) or the static packed-batch engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --requests 8 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --mode qnn8
    PYTHONPATH=src python -m repro_torch.launch.serve --mode dense \
        --spec-draft qnn8 --spec-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --arch mixtral-8x22b \
        --device cpu            # MoE + SWA: engine auto -> static
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-large-v2

Runs on CUDA unless ``--device cpu`` is given; without a GPU it raises.
Weights are initialised from seed 0, as in the reference launcher; with
``--spec-draft`` the seed makes a train-form tree, from which both the
target and the draft are converted (``ServeEngine.from_trained``).

``--arrival-rate R`` (req/s) replays a Poisson arrival process instead of
submitting everything up front: the launcher ticks the slot scheduler and
submits each request when its arrival time elapses
(``serve.scheduler.replay_arrivals``).

Observability (``obs/``, all opt-in):

- ``--trace-out trace.jsonl`` records the run's request-lifecycle spans and
  events to JSONL (``--trace-capacity`` records in a ring buffer), with a
  footer holding the run's metrics summary and per-request stamps, and
  writes ``trace.perfetto.json`` beside it (ui.perfetto.dev);
- ``--metrics-out metrics.prom`` dumps the metrics registry in Prometheus
  text format (a ``.json`` suffix: a JSON snapshot);
- ``--profile-sample N`` phase-times every Nth scheduler tick and prints the
  split; ``--profile-dir DIR`` wraps the drain in a torch.profiler window
  and writes its Chrome trace (kernel names and device times) into DIR.

``--engine auto`` takes the continuous engine where the architecture
supports it and the static engine otherwise (mixture of experts, sliding
windows: mixtral, grok; the recurrent families: zamba2-2.7b, xlstm-125m,
whose states the slot pools do not hold; the encoder-decoder
seamless-m4t-large-v2). The static engine has no scheduler: no metrics,
and ``--arrival-rate`` drains closed loop instead, as in the reference.
For the encoder-decoder family the launcher makes the stub frontend's
frame embeddings, (batch-size, 16, d_model) = 0.1 x a normal sample from a
torch generator seeded 1, and passes them as ``run(extra_batch={"frames":
...})``: the engine trims them to each packed group.

Tensor parallelism: ``--tp N`` serves on a (1, N) ("data", "model") mesh,
``--mesh-shape d,m`` on a (d, m) one (a "data" axis larger than 1 is
refused: data parallelism comes with the training slice). The launcher
builds the kernels once, then spawns one rank a card (NCCL; with
``--device cpu``, gloo ranks on the CPU), joined through a ``FileStore`` in
a temporary directory; every rank serves the same requests on its shard
(``distributed.tp``) and rank 0 prints. The lm family without experts or a
window is served so; ``--arrival-rate`` and ``--spec-draft`` are refused
with a mesh.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --tp 2
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.distributed import comm
from repro_torch.models import build_model
from repro_torch.obs import MetricsRegistry, Tracer, profile_trace, set_tracer
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import replay_arrivals


def _param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_NAMES)
    ap.add_argument("--mode", default="bika", choices=("dense", "bika", "bnn", "qnn8"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--quantized-kv", action="store_true")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "static", "continuous", "paged"),
                    help="auto: continuous where the architecture supports it, else static")
    ap.add_argument("--n-slots", type=int, default=0,
                    help="decode slots (0 -> batch-size)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="paged engine: tokens per KV block")
    ap.add_argument("--kv-n-blocks", type=int, default=0,
                    help="paged engine: physical pool blocks "
                         "(0 -> n_slots * max_len / block_size)")
    ap.add_argument("--prefix-cache", dest="prefix_cache", action="store_true",
                    default=True, help="paged engine: shared-prefix block reuse (default on)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache", action="store_false")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="paged engine: chunked-prefill chunk length")
    ap.add_argument("--paged-attn-route", default="fused", choices=("fused", "gather"),
                    help="paged attention: fused block-table kernel (default) or the "
                         "gather oracle")
    ap.add_argument("--spec-draft", default="",
                    choices=("", "dense", "bika", "bnn", "qnn8", "small"),
                    help="speculative decoding: draft preset built from the same "
                         "trained weights ('' = off)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculative window: the draft proposes k-1 tokens, the target "
                         "verifies k")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrival rate in req/s (0 = submit all up front)")
    ap.add_argument("--trace-out", default="",
                    help="write the request-lifecycle trace JSONL here (and "
                         "<stem>.perfetto.json beside it)")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="trace ring-buffer capacity in records")
    ap.add_argument("--metrics-out", default="",
                    help="dump the metrics registry: Prometheus text, or a JSON snapshot "
                         "when the path ends in .json")
    ap.add_argument("--profile-dir", default="",
                    help="wrap the drain in a torch.profiler window writing its Chrome "
                         "trace here")
    ap.add_argument("--profile-sample", type=int, default=0,
                    help="phase-time every Nth scheduler tick (0 = off)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a GPU) or cpu (plain versions)")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel size: serve on a (1, tp) data x model mesh, one "
                         "rank a card (0 = one process)")
    ap.add_argument("--mesh-shape", default="",
                    help="explicit 'data,model' mesh shape (overrides --tp)")
    args = ap.parse_args(argv)
    shape = _mesh_shape(args)
    if shape is not None:
        return _serve_ranks(args, shape)
    device = resolve_device(args.device)
    tracer = Tracer(capacity=args.trace_capacity) if args.trace_out else None
    prev_tracer = set_tracer(tracer) if tracer is not None else None
    try:
        return _serve(args, device, tracer)
    finally:
        if tracer is not None:
            set_tracer(prev_tracer)


def _mesh_shape(args):
    """(data, model) from ``--mesh-shape`` or ``--tp``; None for one process."""
    if args.mesh_shape:
        shape = tuple(int(v) for v in args.mesh_shape.split(","))
        if len(shape) != 2 or min(shape) < 1:
            raise SystemExit(f"--mesh-shape wants 'data,model', got {args.mesh_shape!r}")
        return shape
    return (1, args.tp) if args.tp > 0 else None


def _serve_ranks(args, shape) -> int:
    """One rank a card (NCCL) or a gloo rank each on the CPU, the kernels
    built before any rank starts; rank 0 prints."""
    from repro_torch.distributed.spawn import spawn_ranks

    world = shape[0] * shape[1]
    if args.arrival_rate > 0 or args.spec_draft:
        raise SystemExit("--arrival-rate and --spec-draft are not served on a mesh: the "
                         "ranks run one closed-loop drain in step")
    if args.device == "cuda":
        resolve_device("cuda")  # raises without a GPU
        if torch.cuda.device_count() < world:
            raise SystemExit(f"a {shape} mesh needs {world} cards, one rank a card; this "
                             f"machine has {torch.cuda.device_count()}")
        from repro_torch.kernels import build

        build.build_all()
    store_dir = tempfile.mkdtemp(prefix="repro-torch-serve-")
    try:
        spawn_ranks(_rank_serve, world, store_dir, (args, shape),
                    backend="nccl" if args.device == "cuda" else "gloo",
                    threads=1 if args.device == "cpu" else None)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    return 0


def _rank_serve(rank, world, args, shape):
    from repro_torch.distributed.meshes import make_mesh

    mesh = make_mesh(shape, ("data", "model"))
    if rank:  # rank 0 alone prints and writes the trace, metrics and profile
        args = argparse.Namespace(**dict(vars(args), trace_out="", metrics_out="",
                                         profile_dir="", profile_sample=0))
    device = resolve_device(args.device)
    tracer = Tracer(capacity=args.trace_capacity) if args.trace_out else None
    prev_tracer = set_tracer(tracer) if tracer is not None else None
    try:
        _serve(args, device, tracer, mesh=mesh, say=print if rank == 0 else _quiet)
    finally:
        if tracer is not None:
            set_tracer(prev_tracer)


def _quiet(*_args, **_kw) -> None:
    pass


def _serve(args, device, tracer, mesh=None, say=print) -> int:
    registry = MetricsRegistry() if (args.metrics_out or args.trace_out) else None

    getter = get_smoke if args.smoke else get_config
    arch = getter(args.arch, compute_mode=args.mode, remat=False)
    if args.mode == "bika":
        arch = arch.replace(pack_signs=True)
    if args.paged_attn_route != arch.paged_attn_route:
        arch = arch.replace(paged_attn_route=args.paged_attn_route)
    eng_kw = dict(batch_size=args.batch_size, max_len=args.max_len,
                  quantized_kv=args.quantized_kv, engine=args.engine,
                  n_slots=args.n_slots or None, kv_block_size=args.kv_block_size,
                  kv_n_blocks=args.kv_n_blocks or None, prefix_cache=args.prefix_cache,
                  prefill_chunk=args.prefill_chunk, device=device, tracer=tracer,
                  registry=registry, profile_sample=args.profile_sample, mesh=mesh)
    if args.spec_draft:
        # the trained float tree, so that the SAME weights convert through
        # the target backend and the cheaper draft backend (serve/spec.py)
        tparams = build_model(arch, phase="train").init(0, device=device)
        say(f"[serve] {arch.name} mode={args.mode} params={_param_bytes(tparams):,} B "
            f"device={device} spec: draft={args.spec_draft} k={args.spec_k}")
        eng = ServeEngine.from_trained(tparams, arch, spec_draft=args.spec_draft,
                                       spec_k=args.spec_k, **eng_kw)
    else:
        api = build_model(arch, phase="serve")
        params = api.init(0, device=device)
        say(f"[serve] {arch.name} mode={args.mode} params={_param_bytes(params):,} B "
            f"device={device}")
        eng = ServeEngine(api, params, arch, **eng_kw)
    say(f"[serve] engine={eng.engine}")
    if mesh is not None:
        say(f"[serve] tp={eng.tp.size} mesh={tuple(mesh.shape)} backend={eng.tp.backend}: "
            f"rank 0 holds {_param_bytes(eng.params):,} B of params")
    comm.reset_collectives()
    rng = np.random.RandomState(0)
    extra = None
    if arch.family == "encdec":
        # sized to the engine's packed batch; the engine trims it to each group
        gen = torch.Generator(device=device).manual_seed(1)
        extra = {"frames": 0.1 * torch.randn((args.batch_size, 16, arch.d_model),
                                             generator=gen, device=device)}
    reqs = []
    for i in range(args.requests):
        plen = int(rng.randint(3, 12))
        reqs.append(Request(rid=i, prompt=rng.randint(0, arch.vocab, plen).astype(np.int32),
                            max_new_tokens=args.new_tokens))
    if args.arrival_rate > 0 and eng.scheduler is None:
        say("[serve] WARNING: --arrival-rate needs a slot-scheduler engine "
            f"(continuous/paged); engine={eng.engine} drains closed-loop instead")
    window = profile_trace(args.profile_dir)
    with window:
        if args.arrival_rate > 0 and eng.scheduler is not None:
            arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate, len(reqs)))
            done, _ = replay_arrivals(eng.scheduler, list(zip(arrivals, reqs)))
        else:
            for r in reqs:
                eng.submit(r)
            done = eng.run(extra_batch=extra)
    for r in sorted(done, key=lambda q: q.rid)[:4]:
        say(f"  req {r.rid}: {[int(t) for t in r.output[:10]]}...")
    say(f"[serve] completed {len(done)} requests")
    if mesh is not None:
        say(f"[serve] collectives: {comm.collective_counts()}")
    m = eng.metrics.summary() if eng.metrics is not None else None
    if m is not None:
        say(f"[serve] goodput={m['goodput_tok_s']:.1f} tok/s "
            f"occupancy={m['slot_occupancy']:.2f} "
            f"prefill compiles={m['prefill_compiles']}")
        if eng.engine == "paged":
            say(f"[serve] prefix hit rate={m['prefix_hit_rate']:.2f} "
                f"blocks peak={m['blocks_in_use_peak']} "
                f"chunks={m['prefill_chunks']} "
                f"deferrals={m['admission_deferrals']}")
        if m.get("spec_rounds"):
            say(f"[serve] spec: rounds={m['spec_rounds']} "
                f"accept rate={m['spec_accept_rate']:.2f} "
                f"tokens/round={m['spec_tokens_per_round']:.2f}")
        say(f"[serve] kv pool={m['kv_pool_bytes']:,} B "
            f"({m['kv_bytes_per_token']:.0f} B/token) "
            f"in-use peak={m['kv_bytes_in_use_peak']:,} B "
            f"decode HBM/token={m['decode_hbm_bytes_per_token']:.0f} B")
    if eng.profiler is not None and eng.profiler.sampled_ticks:
        ps = eng.profiler.summary()
        split = " ".join(f"{k}={v['fraction']:.0%}" for k, v in ps["phases"].items())
        say(f"[serve] profile: {ps['sampled_ticks']}/{ps['ticks']} ticks sampled; {split}")
    if args.profile_dir:
        say(f"[serve] torch.profiler trace -> {window.path}")
    if tracer is not None:
        requests = [r.metrics.to_dict() for r in done if r.metrics is not None] or None
        tracer.write_jsonl(args.trace_out, summary=m, requests=requests)
        stem = args.trace_out[:-6] if args.trace_out.endswith(".jsonl") else args.trace_out
        tracer.write_perfetto(stem + ".perfetto.json")
        say(f"[serve] trace: {len(tracer)} records ({tracer.dropped} dropped) -> "
            f"{args.trace_out}")
    if registry is not None and args.metrics_out:
        if args.metrics_out.endswith(".json"):
            registry.write_json(args.metrics_out)
        else:
            registry.write_prometheus(args.metrics_out)
        say(f"[serve] metrics -> {args.metrics_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
