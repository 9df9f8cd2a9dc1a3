"""What the tensor-parallel serving tests run in their gloo ranks (torch
only: a rank imports no JAX; the tests hold the ranks' results against the
reference in the parent process) and in the single process.

``spawn(fn, world, tmp_dir, *args)`` runs ``fn(rank, world, *args)`` on
``world`` gloo ranks (``repro_torch.distributed.spawn``: a ``FileStore`` in
``tmp_dir``, one torch thread a rank, a timeout on every collective, a
deadline on the whole run) and returns their results in rank order.
"""
from __future__ import annotations

import numpy as np
import torch

GROUP_TIMEOUT_S = 60.0  # a collective waiting on a dead peer raises after this
DEADLINE_S = 300.0  # the whole session


def spawn(fn, world, tmp_dir, *args, backend="gloo"):
    from repro_torch.distributed.spawn import spawn_ranks

    return spawn_ranks(fn, world, str(tmp_dir), args, backend=backend, threads=1,
                       timeout_s=GROUP_TIMEOUT_S, deadline_s=DEADLINE_S)


# ---------------------------------------------------------------------------
# what a rank and the single process run
# ---------------------------------------------------------------------------

RECORD = (("prefill", "prefill"), ("prefill_chunk", "prefill"), ("decode_step", "decode"),
          ("decode_paged", "decode"))


def recording(api, log):
    """``api`` with its serve calls' logits recorded: the first two of the
    prefill kind (prefill, prefill_chunk) and of the decode kind, and every
    returned cache's leaf shapes (the static engine keeps no pool)."""

    def wrap(kind, fn):
        def call(*a, **kw):
            logits, cache = fn(*a, **kw)
            if len(log[kind]) < 2:
                log[kind].append(logits.detach().cpu().numpy())
            log["cache_shapes"] = {k: tuple(v.shape) for k, v in cache.items()}
            return logits, cache
        return call

    for kind in ("prefill", "decode"):
        log.setdefault(kind, [])
    return api._replace(**{name: wrap(kind, getattr(api, name)) for name, kind in RECORD})


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{path}/{i}"))
        return out
    return {path: tuple(tree.shape)}


def serve_case(case, serve_np, mesh=None):
    """One drain of ``case`` (arch, engine, requests) over the serve tree
    ``serve_np`` (numpy leaves), single-process or under ``mesh``: tokens,
    the recorded logits and shapes, param and KV bytes, collectives."""
    from repro_torch.distributed import comm
    from repro_torch.models import build_model
    from repro_torch.nn.module import param_bytes
    from repro_torch.serve import Request, ServeEngine

    arch, engine, prompts, new_tokens = case["arch"], case["engine"], case["prompts"], \
        case["new_tokens"]
    from repro_torch.kernels import ops

    log = {}
    api = recording(build_model(arch, phase="serve"), log)
    params = _tree_from_np(serve_np)
    eng = ServeEngine(api, params, arch, engine=engine, device=case.get("device", "cpu"),
                      mesh=mesh, **case["engine_kw"])
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
    comm.reset_collectives()
    ops.reset_launches()
    done = eng.run()
    res = {"tokens": {r.rid: [int(t) for t in r.output] for r in done},
           "prefill": log["prefill"], "decode": log["decode"],
           "cache_shapes": log.get("cache_shapes"),
           "param_shapes": _shapes(eng.params), "param_bytes": param_bytes(eng.params),
           "collectives": comm.collective_counts(), "launches": ops.launch_counts()}
    if eng.scheduler is not None:
        res["pool_shapes"] = {k: tuple(v.shape) for k, v in eng.scheduler.kv.cache.items()}
        res["pool_bytes"] = eng.scheduler.kv.pool_bytes
        res["ticks"] = eng.metrics.summary()["decode_steps"]
    return res


def _tree_from_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_from_np(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def padded_forward(arch, serve_np, tokens, mesh=None):
    """The serve-phase training forward (``api.apply``) of ``arch`` over
    ``tokens``, single-process or under ``mesh``: (logits, collectives)."""
    from repro_torch.distributed import comm
    from repro_torch.distributed.tp import shard_serve_params, tp_group
    from repro_torch.models import build_model

    api = build_model(arch, phase="serve")
    group = tp_group(mesh)
    params = shard_serve_params(_tree_from_np(serve_np), arch, group)
    comm.reset_collectives()
    with torch.inference_mode(), comm.use(group):
        logits = api.apply(params, {"tokens": torch.from_numpy(tokens)})
    return logits.numpy(), comm.collective_counts()


def _refused(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def refusals(rank, world, mesh, arch, serve_np, moe_arch, moe_np):
    """The messages of what a mesh engine refuses: a "data" axis > 1,
    speculation, an architecture outside the lm family's slot of it."""
    from repro_torch.distributed.meshes import make_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    api = build_model(arch, phase="serve")
    data_mesh = make_mesh((world, 1), ("data", "model"), backend="gloo")
    kw = dict(max_len=32, device="cpu")
    draft = (api, _tree_from_np(serve_np), arch)
    return {
        "data": _refused(lambda: ServeEngine(api, _tree_from_np(serve_np), arch,
                                             mesh=data_mesh, **kw)),
        "spec": _refused(lambda: ServeEngine(api, _tree_from_np(serve_np), arch,
                                             engine="paged", kv_block_size=8, mesh=mesh,
                                             spec_draft=draft, spec_k=4, **kw)),
        "moe": _refused(lambda: ServeEngine(build_model(moe_arch, phase="serve"),
                                            _tree_from_np(moe_np), moe_arch, mesh=mesh,
                                            **kw)),
    }


def serve_cases(rank, world, cases, pad=None, refuse=None):
    """Every case under a (1, world) mesh; with ``pad`` (arch, tree,
    tokens) the padded-head forward, with ``refuse`` the refusals' args."""
    from repro_torch.distributed.meshes import make_mesh

    mesh = make_mesh((1, world), ("data", "model"))
    out = {"cases": [serve_case(case, serve_np, mesh) for case, serve_np in cases]}
    if pad is not None:
        out["pad"] = padded_forward(*pad, mesh=mesh)
    if refuse is not None:
        out["refused"] = refusals(rank, world, mesh, *refuse)
        out["meshes"] = meshes(world)
    return out


def meshes(world):
    """The mesh helpers over the live group: best_effort_mesh's shapes, and
    single_device_mesh's refusal of a group of more than one rank."""
    from repro_torch.distributed.meshes import best_effort_mesh, single_device_mesh

    return {"model_2": tuple(best_effort_mesh(prefer_model=2).shape),
            "model_3": tuple(best_effort_mesh(prefer_model=3).shape),
            "single": _refused(single_device_mesh)}
