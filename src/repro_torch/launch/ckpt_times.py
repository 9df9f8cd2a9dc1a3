"""Time a checkpoint's save and restore at full width and depth.

    PYTHONPATH=src python -m repro_torch.launch.ckpt_times [--mode bika] [--dir DIR]
        [--out FILE] [--device cpu --smoke]

The state is what ``Trainer`` checkpoints: smollm-360m's train-form
parameters (seed 42) and AdamW's m, v and step, on the card. It is saved and
restored by the port's ``checkpoint`` module (sync twice, the first paying
for the pinned host buffers; async; restore onto the card) and, for
comparison, by the reference's route: ``.cpu()`` of every leaf,
``np.savez``, then ``np.load`` and a copy back to the card (the same bytes
on disk: each side reads the other's file, checked). Prints the card's
name and power limit and each time, and with ``--out`` writes them as
JSON. Runs on CUDA unless ``--device cpu``; raises without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, restore
from repro_torch.checkpoint.manager import _flatten_with_paths, _hash
from repro_torch.configs import get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.train.trainer import TrainConfig, Trainer


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="bika", choices=("dense", "bika", "bnn", "qnn8"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dir", default="build", help="where the checkpoints are written "
                                                    "(a temporary directory inside, removed)")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    arch = (get_smoke if args.smoke else get_config)("smollm-360m", compute_mode=args.mode)
    params, opt, _ = Trainer(TrainConfig(arch=arch), device=dev).init()
    state = {"params": params, "opt": opt}
    flat = _flatten_with_paths(state)
    nbytes = sum(v.numel() * v.element_size() if torch.is_tensor(v) else 4 for _, v in flat)
    _sync(dev)
    os.makedirs(args.dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt-times-", dir=args.dir)
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        times[name] = time.perf_counter() - t0
        return out

    try:
        port_dir, ref_dir = os.path.join(tmp, "port"), os.path.join(tmp, "ref")
        mgr = CheckpointManager(port_dir, keep=1)
        timed("port_save_first_s", lambda: mgr.save(1, state))
        timed("port_save_s", lambda: mgr.save(2, state))
        timed("port_save_async_return_s", lambda: mgr.save(3, state, blocking=False))
        t0 = time.perf_counter()
        mgr.wait()
        times["port_save_async_s"] = times["port_save_async_return_s"] + time.perf_counter() - t0
        back, _ = timed("port_restore_s", lambda: restore(port_dir, 3, state, device=dev))
        del back

        def ref_save():
            host = {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v, np.int32)
                    for k, v in flat}
            os.makedirs(ref_dir, exist_ok=True)
            np.savez(os.path.join(ref_dir, "arrays.npz"), **host)

        timed("npsavez_save_s", ref_save)

        def ref_restore():
            with np.load(os.path.join(ref_dir, "arrays.npz")) as data:
                return [torch.from_numpy(data[k]).to(dev) for k, v in flat if torch.is_tensor(v)]

        timed("npload_restore_s", ref_restore)
        # the same bytes either way: the port reads np.savez's file, numpy the port's
        with np.load(os.path.join(port_dir, "step_3", "arrays.npz")) as data:
            key = flat[0][0]
            if _hash(data[key]) != _hash(np.asarray(flat[0][1].cpu())):
                raise SystemExit(f"np.load read other bytes for {key} from the port's file")
        os.makedirs(os.path.join(ref_dir, "step_1"))
        shutil.copy(os.path.join(port_dir, "step_3", "manifest.json"),
                    os.path.join(ref_dir, "step_1"))
        os.replace(os.path.join(ref_dir, "arrays.npz"),
                   os.path.join(ref_dir, "step_1", "arrays.npz"))
        back, _ = restore(ref_dir, 1, state, device=dev)  # hash-verified
        del back
        disk = os.path.getsize(os.path.join(port_dir, "step_3", "arrays.npz"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{card}; smollm-360m {args.mode}, {arch.n_layers} layers, d_model {arch.d_model}: "
          f"{len(flat)} leaves, {nbytes:,} B of state, {disk:,} B on disk")
    for name, t in times.items():
        print(f"  {name:28s} {t:8.3f} s  ({nbytes / t / 1e9:6.2f} GB/s)")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": card, "mode": args.mode, "leaves": len(flat), "bytes": nbytes,
                       "disk_bytes": disk, "times": times}, fh, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
