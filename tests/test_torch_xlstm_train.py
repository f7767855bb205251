"""Port parity of xLSTM training (slice 7b) at xlstm-125m.reduced() (two
whole units: 12 layers, 10 mLSTM and 2 sLSTM, d_model 64, scan chunk 8,
``remat="unit"``), 2 × 64 with three segments a row:

* ``LM.loss`` against the JAX ``LM.loss`` at rtol 1e-5, and every
  gradient leaf (the port's per-layer leaves) at max |Δ| ≤ 1e-3 · max |ref|
  against ``jax.value_and_grad`` on the same weights. The bound is not the
  kernels' 1e-4 / 1e-3: the mLSTM normaliser max(|n·q|, e^−m) nearly
  cancels, so f32 rounding moves the gradient by ~1e-4 of a leaf's scale
  in either package. The same test measures the JAX package's own
  chunk-16 gradient against its chunk-8 one per leaf, holds it to the same
  bound and prints it beside the port's gap (``-s`` shows the table).
  Every gradient is finite.

The JAX side runs jitted at XLA's cheapest options, its conv on the XLA
path (the plain reference of the Pallas kernel #1); its two compiles fill
most of the file's minute, so the rest of slice 7b's CPU tests are
files of their own: the 8-layer unit + tail variant
``tests/test_torch_xlstm_train_tail.py``, the training trajectory
``tests/test_torch_xlstm_train_steps.py``, and the port-only cases (the
clip subgradient's share of the gap, no gradient across a reset, resume,
the dry run's count, the launcher) ``tests/test_torch_xlstm_train_port.py``.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from _threads import one_thread  # noqa: E402
from _xlstm_train import LAYERS, check_loss_and_grads  # noqa: E402

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)


def test_loss_and_every_gradient_match_jax():
    check_loss_and_grads(LAYERS["units"])
