"""Dry run: one step of an (arch, shape) pair on the production mesh of
256 or 512 devices, in one process, with its per-device roofline (the
JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each step on 512 forced host devices
(``--xla_force_host_platform_device_count``) and reads the compiled
per-device HLO.  Here :func:`run_one` brings up a ``fake`` process group
of 256 or 512 ranks (``torch.testing._internal``'s ``FakeStore``: the
collectives run on shapes and move nothing), builds the production
mesh's ``DeviceMesh`` on it as rank 0, places ``build_step``'s meta
example arguments by their specs (``steps.place``) and runs the step once
on those meta tensors, the decode position a Python int (the last one, so
that the attention spans the whole cache), under
:class:`repro_torch.launch.op_analysis.OpAnalysis`.  Nothing parses HLO.

The JSON record keeps the reference's keys and file name, with these
differences:

* ``memory.args_bytes_per_chip`` is the local bytes of the placed
  arguments (each dim divided, rounded up, by the product of its spec's
  mesh-axis sizes); ``output_bytes_per_chip`` the step's outputs' local
  bytes;
* ``hlo_analysis`` holds the op analysis (per device, at local shapes);
* ``lower_s`` is the seconds of the meta step;
* left out, having no counterpart without a compiler: ``compile_s``,
  ``temp_bytes_per_chip`` (and so ``total_bytes_per_chip``, which the
  reference sums from it) and ``xla_cost_analysis``;
* the roofline's constants are an H100's, named below with their
  sources; no TPU constant enters a per-device number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

from repro_torch.configs import ARCHS, ASSIGNED, LONG_CONTEXT_OK

#: H100 SXM5, dense bf16 tensor-core peak (NVIDIA H100 datasheet: 1,979
#: TFLOP/s with 2:4 sparsity, half of it dense)
PEAK_FLOPS = 989.4e12
#: H100 SXM5 HBM3 bandwidth (NVIDIA H100 datasheet)
HBM_BW = 3.35e12
#: per-device collective bandwidth: an axis of 16 devices spans two
#: 8-card HGX H100 nodes, so its ring crosses the inter-node link, one
#: 400 Gb/s NDR InfiniBand adapter per GPU (50 GB/s), not NVLink 4
#: (450 GB/s a direction inside a node)
COLL_BW = 50e9

#: ``--opt`` name -> the rule overrides it installs
OPT_OVERRIDES: Dict[str, Dict[str, object]] = {
    "attn_tp": {"attn_tp": True, "heads_tp": "model"},   # Megatron GQA-TP attention
    "kvseq": {"kv_seq": "model", "kv_heads": None,        # sequence-sharded KV decode
              "kv_head_dim": None, "decode_seq_shard": True},
    "bf16grad": {"bf16_grad": True},                      # bf16 residual-stream cotangents
    "nofsdp": {"dmodel": None},
}

#: where ``main`` writes by default (``build/`` is ignored by git)
DEFAULT_OUT = "build/dryrun"


def runnable(arch: str, shape_name: str) -> bool:
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False
    return True


def fake_process_group(world_size: int) -> None:
    """Rank 0 of a ``fake`` process group of ``world_size`` ranks.  The
    backend lives in ``torch.testing._internal``; a failing import
    raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: Path, overrides=None,
            tag: str = ""):
    """One (arch, shape, mesh) dry run; writes and returns its JSON record.
    The process group is torn down on every exit."""
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.launch import op_analysis, steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES

    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    fake_process_group(chips)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        fn, args, in_shard, out_shard = steps.build_step(
            cfg, shape, multi_pod=multi_pod, rule_overrides=overrides)
        call_args = args[:3] + (shape.seq_len - 1,) if shape.kind == "decode" else args
        placed = steps.place(call_args, in_shard, mesh)
        arg_bytes = op_analysis.local_bytes(placed)
        if shape.kind == "decode":
            arg_bytes += args[3].numel() * args[3].element_size()  # the reference's pos
        t0 = time.time()
        with sharding.use_mesh(mesh), op_analysis.OpAnalysis() as mode:
            out = fn(*placed)
        t_run = time.time() - t0
        out_bytes = op_analysis.local_bytes(out)
    finally:
        dist.destroy_process_group()

    hlo = mode.result
    hlo.argument_bytes = arg_bytes
    # roofline terms, all per device
    compute_t = hlo.flops / PEAK_FLOPS
    memory_t = (hlo.dot_bytes + hlo.argument_bytes) / HBM_BW
    collective_t = hlo.collective_bytes / COLL_BW
    terms = {"compute": compute_t, "memory": memory_t, "collective": collective_t}
    bottleneck = max(terms, key=terms.get)

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = cfg.active_param_count()
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    flops_global = hlo.flops * chips
    useful_ratio = model_flops / flops_global if flops_global else 0.0

    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "kind": shape.kind,
        "tag": tag,
        "lower_s": round(t_run, 1),
        "memory": {
            "args_bytes_per_chip": arg_bytes,
            "output_bytes_per_chip": out_bytes,
        },
        "hlo_analysis": {
            "flops_per_chip": hlo.flops,
            "collective_bytes_per_chip": hlo.collective_bytes,
            "collective_breakdown": hlo.collective_breakdown,
            "collective_op_count": hlo.collective_count,
            "dot_bytes_per_chip": hlo.dot_bytes,
            "argument_bytes_per_chip": hlo.argument_bytes,
        },
        "roofline": {
            "compute_s": compute_t,
            "memory_s": memory_t,
            "collective_s": collective_t,
            "bottleneck": bottleneck,
            "model_flops_global": model_flops,
            "hlo_flops_global": flops_global,
            "useful_flops_ratio": useful_ratio,
            "params": cfg.param_count(),
            "active_params": n_active,
        },
    }

    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = out_dir / f"{arch}__{shape_name}__{result['mesh']}{suffix}.json"
    path.write_text(json.dumps(result, indent=2))

    print(f"[dryrun] {arch} × {shape_name} × {result['mesh']}{suffix}: "
          f"step={t_run:.1f}s args/chip={arg_bytes / 2**30:.2f}GiB "
          f"compute={compute_t * 1e3:.2f}ms memory={memory_t * 1e3:.2f}ms "
          f"collective={collective_t * 1e3:.2f}ms -> {bottleneck} "
          f"useful={useful_ratio:.2f}")
    return result


def overrides_of(opts: str):
    """``--opt a,b`` -> (rule overrides or None, tag suffix list)."""
    overrides = {}
    names = [o for o in opts.split(",") if o] if opts else []
    for opt in names:
        if opt not in OPT_OVERRIDES:
            raise SystemExit(f"unknown --opt {opt}")
        overrides.update(OPT_OVERRIDES[opt])
    return overrides or None, names


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Multi-pod dry run: one step of every (arch × shape × mesh) on a fake mesh")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=["train_4k", "prefill_32k", "decode_32k", "long_500k"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="run all combos in subprocesses")
    ap.add_argument("--force", action="store_true", help="re-run existing artifacts")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="", help="artifact tag (perf experiments)")
    ap.add_argument("--opt", default=None,
                    help="comma list of perf options: " + ",".join(OPT_OVERRIDES))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    if args.all:
        from repro_torch.launch.shapes import SHAPES

        failures = []
        for arch in ASSIGNED:
            for shape_name in SHAPES:
                if not runnable(arch, shape_name):
                    print(f"[dryrun] SKIP {arch} × {shape_name} (full attention)")
                    continue
                for mp in (False, True):
                    mesh_name = "2x16x16" if mp else "16x16"
                    art = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
                    if art.exists() and not args.force:
                        print(f"[dryrun] cached {art.name}")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape_name, "--out", str(out_dir)]
                    if mp:
                        cmd.append("--multi-pod")
                    r = subprocess.run(cmd, env={**os.environ})
                    if r.returncode != 0:
                        failures.append((arch, shape_name, mesh_name))
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("[dryrun] every combination ran one step")
        return

    if not (args.arch and args.shape):
        raise SystemExit("--arch and --shape required (or --all)")
    if not runnable(args.arch, args.shape):
        print(f"[dryrun] {args.arch} × {args.shape} skipped by design (full attention)")
        return
    overrides, names = overrides_of(args.opt)
    tag = "+".join(([args.tag] if args.tag else []) + names)
    run_one(args.arch, args.shape, args.multi_pod, out_dir, overrides=overrides, tag=tag)


if __name__ == "__main__":
    main()
