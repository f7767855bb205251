"""One count of a step's work, the same on the meta device, the CPU and the
card: the port's stand-in for XLA's ``compiled.cost_analysis()`` plus the
JAX package's ``hlo_static.analyze``.

``StepCounter(device)`` is a ``TorchDispatchMode``. For every aten op the
step issues that touches a tensor on ``device`` (ops on host tensors alone,
such as the CUDA RNG state a recomputed layer restores, are bookkeeping):

* FLOPs through ``torch.utils.flop_counter``'s registry (the matmuls), by
  unit from the first operand's dtype: bf16 and f16 on the tensor cores
  ("bf16"); f32 in TF32 when ``torch.backends.cuda.matmul.allow_tf32`` is
  on, else at the f32 rate; ops outside the registry add no FLOPs;
* bytes: the inputs' and the outputs' ``nbytes``; a view op moves none and
  an allocation (``empty``) writes none; an in-place op's destination
  counts as read and written. ``log_sigmoid``'s buffer (a scratch tensor
  of the input's size on the CPU and the meta device, empty on the card)
  counts nowhere, so each device's count is the card's.

Inside a kernel entry (``kernels/ops.py`` marks each one) the ops issued
are not tallied: the kernel's bytes and operations from
``kernel_model.kernel_work`` are charged instead, and the call is tallied
by the kernel's name. So the count reads the same work whichever code
computes the kernel: the CUDA kernel, its plain version on the CPU, or the
shape-only path on the meta device.

``peak_bytes`` is the peak of the live bytes of the storages the step
creates on ``device`` (tensors that existed before the count are its
arguments, not counted): the dry run's ``temp_size_in_bytes``.
"""
from __future__ import annotations

import collections
import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import UNITS
from repro_torch.roofline.kernel_model import kernel_work

_aten = torch.ops.aten
_ALLOC = {_aten.empty.memory_format, _aten.empty_like.default,
          _aten.empty_strided.default, _aten.new_empty.default}
# ops with a scratch tensor that only some devices fill: where it sits
_SCRATCH_OUT = {_aten.log_sigmoid_forward.default: 1}
_SCRATCH_IN = {_aten.log_sigmoid_backward.default: 2}


def flop_unit(dtype: torch.dtype) -> str:
    """The unit a product of ``dtype`` operands runs in on the card."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "f32"


class StepCounter(TorchDispatchMode):
    """Counts what runs under it (``with StepCounter("meta") as c: ...``);
    read ``c.totals()``. One counter at a time."""

    def __init__(self, device):
        super().__init__()
        self.device_type = torch.device(device).type
        self.flops = dict.fromkeys(UNITS, 0)
        self.bytes = 0
        self.traffic_by_op = collections.Counter()   # matmul, kernels, other
        self.kernels = collections.Counter()
        self.peak_bytes = 0
        self._live = {}
        self._cur = 0
        self._depth = 0

    def __enter__(self):
        from repro_torch.kernels import ops
        if ops.WORK_COUNTER is not None:
            raise RuntimeError("a step counter is already counting")
        ops.WORK_COUNTER = self
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.WORK_COUNTER = None
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def kernel(self, name: str, *args):
        """One call of kernel ``name`` (``kernel_model.KERNEL_WORK``'s
        arguments): charged by its model; the ops inside are not tallied."""
        if self._depth == 0:
            w = kernel_work(name, *args)
            self.kernels[name] += 1
            self.flops[w.unit] += w.flops
            self.bytes += w.bytes
            self.traffic_by_op[name] += w.bytes
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    def _free(self, key):
        self._cur -= self._live.pop(key)

    def _track(self, ins, outs):
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.device.type != self.device_type:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self._cur += st.nbytes()
            self.peak_bytes = max(self.peak_bytes, self._cur)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self._track(ins, outs)
        if self._depth or func.is_view or func in _ALLOC or not any(
                t.device.type == self.device_type for t in ins + outs):
            return out
        nbytes = sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        if func in _SCRATCH_OUT:
            nbytes -= out[_SCRATCH_OUT[func]].nbytes
        elif func in _SCRATCH_IN:
            nbytes -= args[_SCRATCH_IN[func]].nbytes
        self.bytes += nbytes
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[flop_unit(ins[0].dtype)] += int(
                flop_registry[packet](*args, **kwargs, out_val=out))
            self.traffic_by_op["matmul"] += nbytes
        else:
            self.traffic_by_op["other"] += nbytes
        return out

    def totals(self) -> dict:
        return {"flops": sum(self.flops.values()),
                "flops_by_unit": dict(self.flops), "bytes": self.bytes,
                "traffic_by_op": dict(self.traffic_by_op),
                "kernels": dict(self.kernels),
                "peak_bytes": self.peak_bytes}


def count_call(fn, *args, device, **kwargs):
    """``fn(*args, **kwargs)`` under a ``StepCounter(device)``: returns
    (its result, the counter's ``totals()``)."""
    with StepCounter(device) as c:
        out = fn(*args, **kwargs)
    return out, c.totals()
