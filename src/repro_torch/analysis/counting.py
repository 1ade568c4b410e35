"""Counting a step's work on the ``meta`` device.

The port's counterpart of XLA's ``cost_analysis``: the step runs on
``meta`` tensors (no memory, no arithmetic; every kernel op takes its
plain version, ``kernels/ops.py``) under two dispatch modes:
  * ``FlopCounterMode`` counts the FLOPs of the products (matmul, bmm,
    attention, convolution) as PyTorch's own counter does;
  * :class:`ByteCounter` sums each aten op's input and output tensor bytes
    (a view moves none; an indexed read or an in-place indexed write moves
    its indices and the rows it reads or writes), the port's "bytes
    accessed": each op read and written once, unfused, as the HLO's count
    is before fusion and as the eager path runs; but a kernel op
    (``kernels/ops.py``: attention, decode, delta, GLA, paged) counts as
    its kernel moves bytes on the card, each input read once and each
    output written once, however its plain version gets there: while it
    counts, the counter wraps ``ops._run_plain``, the one call through
    which every kernel op runs its plain version.
Every Python loop (the layers, the chunked scans, the microbatches) runs
and is counted, so the counts are whole-step counts.

:func:`step_fn` builds the step of a dry-run cell on ``meta``: a train step
(AdamW, remat, ``mb`` microbatches), a prefill, or one decode step.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops
from repro_torch.launch import input_specs as specs
from repro_torch.models import Model

# ops that allocate or relabel without touching memory
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_unsafe_view"}
# in-place indexed writes (self, index..., values) and indexed reads
# (self, index...)
_WRITES_INTO = {"index_put_", "index_copy_", "index_add_", "scatter_",
                "scatter_add_", "masked_scatter_"}
_READS_FROM = {"index", "index_select", "gather", "embedding", "take"}


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_bytes(v) for v in x.values())
    return 0


class ByteCounter(TorchDispatchMode):
    """Sums the tensor bytes each aten op reads and writes (see the module
    docstring); ``ops`` counts the ops that move bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.paused = False
        self._inner = None

    def add(self, inputs, outputs):
        self.bytes += _bytes(inputs) + _bytes(outputs)
        self.ops += 1

    def _run_plain(self, plain, *inputs):
        """A kernel op's plain version, counted at the kernel's boundary
        on ``meta`` (the ops inside it are not counted)."""
        if self.paused or inputs[0].device.type != "meta":
            return self._inner(plain, *inputs)
        self.paused = True
        try:
            out = self._inner(plain, *inputs)
        finally:
            self.paused = False
        self.add(inputs, out)
        return out

    def __enter__(self):
        self._inner, ops._run_plain = ops._run_plain, self._run_plain
        return super().__enter__()

    def __exit__(self, *exc):
        ops._run_plain, self._inner = self._inner, None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if self.paused or getattr(func, "is_view", False) \
                or name in _NO_BYTES:
            return out
        if name in _WRITES_INTO:
            # an in-place indexed write touches only the rows it writes:
            # the indices and values read, the values written
            src = [a for a in (*args[1:], *kwargs.values())
                   if isinstance(a, (torch.Tensor, list, tuple))]
            self.add(src, src[-1])
        elif name in _READS_FROM:
            # an indexed read touches only the rows it reads: the indices
            # read, the rows read and written
            self.add((args[1:], kwargs, out), out)
        else:
            self.add((args, kwargs), out)
        return out


def count(fn) -> dict:
    """``fn()`` under both counters: {"flops", "bytes", "ops"}."""
    with FlopCounterMode(display=False) as fc, ByteCounter() as bc:
        fn()
    return {"flops": float(fc.get_total_flops()), "bytes": float(bc.bytes),
            "ops": bc.ops}


def step_fn(cfg, kind: str, B: int, S: int, mb: int = 1,
            headroom: int = 64, params=None, perf=None):
    """A no-argument callable that runs one ``kind`` step ("train",
    "prefill" or "decode") of ``cfg`` on ``meta`` at batch ``B`` and
    sequence ``S`` (a decode step's cache holds ``S + headroom`` rows and
    its rows' lengths are ``S``).  ``params``: a ``meta`` tree, else
    drawn.  ``perf``: the model's ``PerfFlags`` (default the baseline)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models.perf_flags import PerfFlags
    from repro_torch.params import requires_grad
    from repro_torch.training import (TrainConfig, init_opt_state,
                                      make_train_step)

    shape = ShapeSpec("probe", kind, S, B)
    perf = perf or PerfFlags()
    if params is None:
        params = specs.params_specs(cfg)
    if kind == "train":
        tc = TrainConfig(microbatches=mb)
        step = make_train_step(Model(cfg, remat=True, perf=perf), tc)
        requires_grad(params)
        state = init_opt_state(params, tc)
        batch = specs.train_batch_specs(cfg, shape)
        return lambda: step(params, state, batch)
    model = Model(cfg, perf=perf)
    if kind == "prefill":
        batch = specs.prefill_batch_specs(cfg, shape)

        def prefill():
            with torch.no_grad():
                return model.prefill(params, batch)
        return prefill
    tokens, caches, _ = specs.decode_specs(cfg, shape, headroom=headroom)
    lengths = torch.full((B,), S, dtype=torch.int32, device=specs.META)

    def decode():
        with torch.no_grad():
            return model.decode_step(params, tokens, caches, lengths)
    return decode
