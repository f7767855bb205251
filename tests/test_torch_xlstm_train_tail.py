"""Port parity of xLSTM training (slice 7b) on the 8-layer unit + tail
variant of xlstm-125m.reduced() (one unit of 5 mLSTM + 1 sLSTM, then 2
tail mLSTM layers that reuse the unit's prefix; d_model 64, scan chunk 8,
``remat="unit"``), 2 × 64 with three segments a row: ``LM.loss`` against
the JAX ``LM.loss`` at rtol 1e-5, and every gradient leaf at max |Δ| ≤
1e-3 · max |ref|, beside the JAX package's own chunk-16 against chunk-8
gap, which the same test holds to the same bound
(``tests/test_torch_xlstm_train.py`` gives the reasons for the bound; it
runs the 12-layer config, since the two JAX compiles of each config fill
most of a file's minute).
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from _xlstm_train import LAYERS, check_loss_and_grads, one_thread  # noqa

_one_thread = pytest.fixture(autouse=True, scope="module")(one_thread)


def test_loss_and_every_gradient_match_jax():
    check_loss_and_grads(LAYERS["unit_plus_tail"])
