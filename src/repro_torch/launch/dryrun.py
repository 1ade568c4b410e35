"""Dry run: count every (architecture x input shape) cell on the ``meta``
device for the production meshes (``src/repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mistral-nemo-12b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each cell for 256 or 512 host devices
and reads XLA's cost and memory analyses.  Here a cell runs once on
``meta`` tensors (no GPU, no process group, no memory) under the cell's
perf variant (``models/perf_flags.py``; ``--perf-variant NAME[+mbN]``,
N the train microbatches): the train step (AdamW state on ``meta``,
remat, the shape's microbatches), the prefill, or one decode step over a
``seq_len + 64`` cache.  Its whole-step FLOPs and bytes are counted
(``analysis/counting.py``), its collectives reckoned from the sharding
rules (``analysis/roofline.py``), and the static bytes a device holds
(params, optimizer state and caches, each divided as its spec says)
stand in for ``memory_analysis``.  One JSON per cell lands in
``build/dryrun/``; an existing one is skipped unless ``--force``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun")

# per-shape training microbatches (activation-memory control)
TRAIN_MICROBATCHES = {"train_4k": 16}
DECODE_HEADROOM = 64

def _tree_device_bytes(tree, specs, mesh, itemsize=None) -> float:
    """Bytes a device holds of ``tree`` laid out by ``specs`` (each leaf
    at ``itemsize`` bytes an element when given)."""
    from repro_torch.distributed.sharding import shard_factor
    if isinstance(tree, dict):
        return sum(_tree_device_bytes(tree[k], specs[k], mesh, itemsize)
                   for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_tree_device_bytes(t, s, mesh, itemsize)
                   for t, s in zip(tree, specs))
    return (tree.numel() * (itemsize or tree.element_size())
            / shard_factor(specs, mesh))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               perf_variant: str = "baseline"):
    """Count one cell.  Returns its report dict."""
    from repro_torch.analysis import counting, roofline
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import input_specs as specs
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, mesh_fingerprint
    from repro_torch.models.perf_flags import VARIANTS

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = sh.abstract_mesh(*PRODUCTION_SHAPES[multi_pod])
    chips = math.prod(mesh.axis_sizes)
    base = perf_variant.split("+")[0]
    if base not in VARIANTS:
        raise ValueError(f"unknown perf variant {base!r}; the port's are "
                         f"{sorted(VARIANTS)}")
    var = VARIANTS[base]
    mb = TRAIN_MICROBATCHES.get(shape_name, 1) if shape.kind == "train" else 1
    for part in perf_variant.split("+")[1:]:
        if part.startswith("mb"):
            mb = int(part[2:])
    B, S = shape.global_batch, shape.seq_len

    t0 = time.time()
    params = specs.params_specs(cfg)
    p_specs = sh.params_shardings(params, mesh, fsdp=var.fsdp)
    static = {"params": _tree_device_bytes(params, p_specs, mesh)}
    if shape.kind == "train":
        # AdamW: float32 mu, nu and master, laid out as the params
        static["optimizer"] = 3 * _tree_device_bytes(
            params, p_specs, mesh, itemsize=4)
    elif shape.kind == "decode":
        _, caches, _ = specs.decode_specs(cfg, shape,
                                          headroom=DECODE_HEADROOM)
        static["caches"] = _tree_device_bytes(
            caches, sh.cache_shardings(caches, mesh,
                                       shard_seq_over_data=(B == 1),
                                       shard_headdim=var.shard_headdim),
            mesh)
        del caches
    counts = counting.count(counting.step_fn(
        cfg, shape.kind, B, S, mb=mb, headroom=DECODE_HEADROOM,
        params=params, perf=var.flags))
    coll = roofline.collective_bytes(
        cfg, shape.kind, B, S, mesh, fsdp=var.fsdp, mb=mb, params=params,
        shard_headdim=var.shard_headdim)
    t_count = time.time() - t0
    mesh_name = "multi" if multi_pod else "single"
    static_total = sum(static.values())
    rep = roofline.analyze(arch, shape_name, mesh_name, chips, counts, coll,
                           cfg, shape, shape.kind,
                           memory_stats=static_total)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "perf_variant": perf_variant, "chips": chips, "kind": shape.kind,
        "microbatches": mb, "mesh_fingerprint": mesh_fingerprint(mesh),
        "count_s": round(t_count, 1), "counts": counts,
        "static_bytes_per_device": static,
        "roofline": rep.to_dict(),
    }


def cell_list(archs=None, shapes=None, include_paper_model=False):
    from repro_torch.configs import SHAPES, all_configs
    out = []
    for name, cfg in all_configs(
            assigned_only=not include_paper_model).items():
        if archs and name not in archs:
            continue
        for sname, shape in SHAPES.items():
            if shapes and sname not in shapes:
                continue
            if shape.sub_quadratic_only and not cfg.runs_long_context:
                continue
            if name == "kimi-linear-1t" and shape.kind == "train":
                continue  # 1T training needs more than 512 devices
            out.append((name, sname))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--perf-variant", default="baseline")
    ap.add_argument("--include-paper-model", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = cell_list([args.arch] if args.arch else None,
                      [args.shape] if args.shape else None,
                      include_paper_model=args.include_paper_model)
    failures = []
    for arch, sname in cells:
        for multi in meshes:
            mesh_name = "multi" if multi else "single"
            tag = f"{arch}__{sname}__{mesh_name}"
            if args.perf_variant != "baseline":
                tag += f"__{args.perf_variant}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[skip] {tag}")
                continue
            print(f"[run ] {tag} ...", flush=True)
            try:
                report = lower_cell(arch, sname, multi, args.perf_variant)
                with open(path, "w") as f:
                    json.dump(report, f, indent=1)
                r = report["roofline"]
                print(f"[ok  ] {tag}: count={report['count_s']}s "
                      f"dominant={r['dominant']} "
                      f"roofline={r['roofline_frac']:.3f} "
                      f"(c={r['t_compute']:.4f}s m={r['t_memory']:.4f}s "
                      f"x={r['t_collective']:.4f}s)", flush=True)
            except Exception as e:
                failures.append((tag, str(e)))
                with open(path + ".fail", "w") as f:
                    f.write(traceback.format_exc())
                print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:200]}",
                      flush=True)
    print(f"\n{len(cells) * len(meshes) - len(failures)} ok, "
          f"{len(failures)} failed")
    if failures:
        for t, e in failures:
            print(" -", t, e[:120])
        raise SystemExit(1)


if __name__ == "__main__":
    main()
