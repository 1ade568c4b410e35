"""The port's twin of the reference's ``examples/serve_cross_dc.py`` on the
CPU: the reference script runs in-process (``runpy``) and the twin, given
the reference run's parameters, routes every request of both turns the
same way, finds the same cached prefixes, ships the same KV bytes over the
link (to the byte the example prints), decodes the same first-turn tokens and ends with the same
thresholds.  Wall times (prefill, TTFT) are not compared."""
import runpy

import torch

from _torch_parity import ROOT, to_torch
from repro_torch.examples import serve_cross_dc

torch.set_num_threads(1)


def test_serve_cross_dc_matches_the_reference():
    ref = runpy.run_path(str(ROOT / "examples" / "serve_cross_dc.py"))
    reqs, out, dep, m = serve_cross_dc.main(["--device", "cpu"],
                                            params=to_torch(ref["params"]))
    want = ref["reqs"] + ref["follow"]
    assert [r.rid for r in reqs] == [r.rid for r in want]
    for r, w in zip(reqs, want):
        assert (r.route, r.cached_tokens, r.kv_bytes, r.kv_bytes_raw) == \
            (w.route, w.cached_tokens, w.kv_bytes, w.kv_bytes_raw), r.rid
        assert r.transfer_s == w.transfer_s, r.rid
    assert {r.route for r in reqs} == {"pd", "prfaas"}
    assert any(r.cached_tokens for r in reqs[6:])
    for rid, resp in ref["out"].items():
        assert out[rid].output_tokens == list(resp.output_tokens), rid
    # the fluid link sums its flows' bytes over time steps: the printed
    # byte count
    assert round(dep.link.sent_bytes) == round(ref["dep"].link.sent_bytes) \
        > 0
    for k in ("requests", "offloaded", "kv_bytes_total", "cache_hit_rate",
              "thresholds"):
        assert m[k] == ref["m"][k], k
