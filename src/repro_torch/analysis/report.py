"""The roofline table of the dry run (``src/repro/analysis/report.py``):
``build/dryrun/`` cell counts -> three roofline terms per cell on the card.

    PYTHONPATH=src python -m repro_torch.analysis.report

A ``meta`` count runs every loop, so the dry run's own counts are exact
and are each row's only source (the reference reads fits of unrolled
probes; the port needs none, ``analysis/costfit.py``).  Writes
``build/roofline_baseline.json`` and prints a markdown table.
"""
from __future__ import annotations

import json
import os

from repro_torch.analysis.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.configs import SHAPES

BUILD = os.path.join(os.path.dirname(__file__), "../../../build")
DRYRUN = os.path.join(BUILD, "dryrun")


def cell_report(arch: str, shape_name: str, variant: str = "baseline",
                dryrun: str = DRYRUN):
    """One roofline row from the cell's single-pod dry-run JSON."""
    tag = f"{arch}__{shape_name}__single"
    if variant != "baseline":
        tag += f"__{variant}"
    path = os.path.join(dryrun, tag + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        full = json.load(f)
    kind = SHAPES[shape_name].kind
    chips = full["chips"]
    flops_dev = full["counts"]["flops"] / chips
    bytes_dev = full["counts"]["bytes"] / chips
    coll_dev = full["roofline"]["collective_detail"]["total"]
    t_c = flops_dev / PEAK_FLOPS
    t_m = bytes_dev / HBM_BW
    t_x = coll_dev / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    model_flops = full["roofline"]["model_flops"]
    achievable = max(terms.values())
    row = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "kind": kind, "chips": chips, "cost_source": "meta-count",
        "hlo_flops_global": full["counts"]["flops"],
        "hlo_bytes_global": full["counts"]["bytes"],
        "coll_bytes_global": coll_dev * chips,
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
        "dominant": max(terms, key=terms.get),
        "model_flops": model_flops,
        "useful_flops_frac": (model_flops / full["counts"]["flops"]
                              if full["counts"]["flops"] else 0.0),
        "roofline_frac": (model_flops / (chips * PEAK_FLOPS) / achievable
                          if achievable else 0.0),
        "count_s": full["count_s"],
        "static_bytes_per_device": full["static_bytes_per_device"],
        "collective_schedule": full["roofline"]["collective_detail"],
    }
    return row


def all_cells(variant: str = "baseline", dryrun: str = DRYRUN):
    out = []
    for fn in sorted(os.listdir(dryrun)):
        if not fn.endswith("__single.json"):
            continue
        arch, shape_name, _ = fn[:-5].split("__")
        rep = cell_report(arch, shape_name, variant, dryrun)
        if rep:
            out.append(rep)
    return out


def markdown_table(cells):
    hdr = ("| arch | shape | kind | compute s | memory s | collective s | "
           "dominant | 6ND/counted | roofline frac |")
    lines = [hdr, "|" + "---|" * 9]
    for c in cells:
        lines.append(
            f"| {c['arch']} | {c['shape']} | {c['kind']} "
            f"| {c['t_compute_s']:.4f} | {c['t_memory_s']:.4f} "
            f"| {c['t_collective_s']:.4f} | **{c['dominant']}** "
            f"| {c['useful_flops_frac']:.2f} | {c['roofline_frac']:.3f} |")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dryrun", default=DRYRUN)
    ap.add_argument("--out", default=os.path.join(BUILD,
                                                  "roofline_baseline.json"))
    args = ap.parse_args(argv)
    cells = all_cells(dryrun=args.dryrun)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(cells, f, indent=1)
    print(markdown_table(cells))
    print(f"\n{len(cells)} cells -> {args.out}")
    return cells


if __name__ == "__main__":
    main()
