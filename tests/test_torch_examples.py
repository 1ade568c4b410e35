"""The port's twins of the reference's ``examples/quickstart.py`` and
``examples/capacity_planner.py`` on the CPU: each reference script runs
in-process (``runpy``) and its twin prints the same text.  The
quickstart's smoke model gets the reference run's own parameters, so its
shipped KV bytes and its eight decoded tokens are the reference's too."""
import runpy

import torch

from _torch_parity import ROOT, to_torch
from repro_torch.examples import capacity_planner, quickstart

torch.set_num_threads(1)


def test_quickstart_prints_the_reference(capsys):
    ref = runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    want = capsys.readouterr().out
    got = quickstart.main(["--device", "cpu"],
                          params=to_torch(ref["params"]))
    assert capsys.readouterr().out == want
    assert got["tokens"] == ref["out"] and got["kv_bytes"] == ref["nbytes"]


def test_capacity_planner_prints_the_reference(capsys):
    ref = runpy.run_path(str(ROOT / "examples" / "capacity_planner.py"))
    want = capsys.readouterr().out
    best, m, m3 = capacity_planner.main()
    assert capsys.readouterr().out == want
    assert "cost/SLO frontier" in want
    assert best[1] == ref["best"][1] and m == ref["m"] and m3 == ref["m3"]
