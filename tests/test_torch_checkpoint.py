"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``): the cases
of ``tests/test_checkpoint.py`` but the mesh one (a single card has no
mesh), on named tensors and ``AdamWState`` instead of pytrees — roundtrip,
keep-K GC, async save, no partial step visible, a missing leaf, async
errors at ``wait()`` and at the next ``save()``, corrupt or missing
arrays, an unpublished step — plus a bf16 + f32 round trip, bitwise, and
an async save followed at once by an in-place AdamW step, whose restore
must equal the state at the save (the port's optimizer writes its tensors
in place, so the snapshot must be a copy). Every comparison is bitwise:
the checkpoint stores the bits.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.obs.check import check_trace  # noqa: E402
from repro_torch.optim.adamw import AdamW, AdamWConfig, AdamWState  # noqa
from repro_torch.optim.adamw import constant_schedule  # noqa: E402


def _tree(rng):
    return {"params": {"w": torch.as_tensor(rng.normal(size=(4, 3)),
                                            dtype=torch.float32),
                       "emb": torch.as_tensor(rng.normal(size=(8, 2)))
                       .to(torch.bfloat16)},
            "opt": {"m": torch.zeros((4, 3)), "step": 7}}


def _zeros_like(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _zeros_like(v)
        elif torch.is_tensor(v):
            out[k] = torch.zeros_like(v)
        else:
            out[k] = type(v)(0)
    return out


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_equal(got[k], want[k])
        elif torch.is_tensor(want[k]):
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
        else:
            assert type(got[k]) is type(want[k]) and got[k] == want[k], k


def test_roundtrip(tmp_path, rng):
    obs = Obs.off()
    mgr = CheckpointManager(str(tmp_path), keep=2, obs=obs)
    tree = _tree(rng)
    mgr.save(10, tree, meta={"step": 10, "note": "x"}, blocking=True)
    assert mgr.latest_step() == 10
    got = mgr.restore(_zeros_like(tree))
    _assert_equal(got, tree)
    assert mgr.read_meta(10)["meta"]["note"] == "x"
    on_disk = sum(f.stat().st_size for f in (tmp_path / "step_10").iterdir())
    assert obs.metrics.gauge("ckpt.bytes").value == on_disk > \
        4 * 3 * 4 + 8 * 2 * 2


def test_bf16_and_f32_roundtrip_bitwise(tmp_path):
    """Every bf16 bit pattern (NaNs, infs, subnormals, -0) and odd f32
    values survive: bf16 goes through its int16 view, the manifest holds
    the logical dtype; a Python float is kept at 64 bits (0.1 is not an
    f32 value)."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    tree = {"bf16": bits.view(torch.bfloat16).reshape(256, 256),
            "f32": torch.tensor([0.0, -0.0, 1e-45, float("inf"), -3.5,
                                 float("nan")]),
            "i64": torch.tensor([2 ** 40, -1]), "n": 3.25, "tenth": 0.1,
            "big": 2 ** 40 + 1}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=True)
    meta = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert meta["dtypes"] == ["bfloat16", "float32", "int64", "float64",
                              "float64", "int64"]
    got = mgr.restore({"bf16": torch.zeros(256, 256, dtype=torch.bfloat16),
                       "f32": torch.zeros(6), "i64": torch.zeros(
                           2, dtype=torch.int64), "n": 0.0, "tenth": 0.0,
                       "big": 0})
    assert got["tenth"] == 0.1 and got["big"] == 2 ** 40 + 1
    assert torch.equal(got["bf16"].view(torch.int16),
                       tree["bf16"].view(torch.int16))
    assert torch.equal(got["f32"].view(torch.int32),
                       tree["f32"].view(torch.int32))
    assert torch.equal(got["i64"], tree["i64"]) and got["n"] == 3.25


def test_keep_k_gc(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree(rng)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_async_save(tmp_path, rng):
    """The write runs on the writer thread; the save is metered through
    ``obs`` (counter, gauges, spans that pass ``obs.check``)."""
    obs = Obs.on()
    mgr = CheckpointManager(str(tmp_path / "c"), keep=3, obs=obs)
    tree = _tree(rng)
    mgr.save(5, tree)
    mgr.wait()
    assert mgr.latest_step() == 5
    got = mgr.restore(_zeros_like(tree))
    _assert_equal(got, tree)
    g = obs.metrics.gauge
    assert obs.metrics.counter("ckpt.saves").value == 1
    assert g("ckpt.write_s").value > 0 and g("ckpt.snapshot_ms").value > 0
    writes = [e for e in obs.tracer.chrome_events()
              if e["name"] == "ckpt.write" and e["ph"] == "B"]
    assert [e["args"]["step"] for e in writes] == [5]
    trace = obs.export(str(tmp_path / "trace.json"))
    assert check_trace(trace, require=["ckpt.saves", "ckpt.bytes"],
                       require_spans=["ckpt.save", "ckpt.wait",
                                      "ckpt.snapshot", "ckpt.write"]) == []


def test_mark_waits_for_the_write_and_replaces_only_the_manifest(
        tmp_path, monkeypatch):
    """The trainer's emergency save of a step it has just saved: ``mark``
    joins the write in flight and rewrites the manifest alone, so it costs
    the wait and no second snapshot or array write (each write is held
    0.4 s here: a second one would take the mark past 0.8 s)."""
    real, writes = np.savez, []

    def slow(*a, **k):
        writes.append(a[0])
        time.sleep(0.4)
        return real(*a, **k)

    monkeypatch.setattr(np, "savez", slow)
    obs = Obs.off()
    mgr = CheckpointManager(str(tmp_path), obs=obs)
    mgr.save(4, {"a": torch.arange(3.0)}, meta={"step": 4})
    t0 = time.perf_counter()
    mgr.mark(4, {"step": 4, "emergency": True})
    took = time.perf_counter() - t0
    assert len(writes) == 1 and took < 0.8
    assert mgr.read_meta(4)["meta"] == {"step": 4, "emergency": True}
    assert obs.metrics.counter("ckpt.saves").value == 1
    assert obs.metrics.counter("ckpt.marks").value == 1
    assert sorted(os.listdir(tmp_path / "step_4")) == ["arrays.npz",
                                                       "manifest.json"]
    got = mgr.restore({"a": torch.zeros(3)})
    assert torch.equal(got["a"], torch.arange(3.0))


def test_resave_of_a_published_step_replaces_it(tmp_path):
    """Saving a step that is already published sets the old copy aside
    until the new one is renamed in, then removes it."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"a": torch.zeros(2)}, blocking=True)
    mgr.save(2, {"a": torch.ones(2)}, blocking=True)
    assert sorted(os.listdir(tmp_path)) == ["step_2"]
    assert torch.equal(mgr.restore({"a": torch.zeros(2)})["a"],
                       torch.ones(2))


def test_async_save_then_in_place_adamw_step_restores_the_saved_state(
        tmp_path, rng, monkeypatch):
    """The writer is held until an in-place AdamW step has overwritten the
    parameters, m, v, masters and step: the restore must still equal the
    state at the save."""
    params = {"w": torch.as_tensor(rng.normal(size=(6, 5)),
                                   dtype=torch.float32).to(torch.bfloat16),
              "b": torch.as_tensor(rng.normal(size=(5,))).to(torch.bfloat16)}
    opt = AdamW(constant_schedule(1e-2), AdamWConfig(clip_norm=None))
    st = opt.init(params)
    for _ in range(2):
        opt.update({k: torch.ones_like(p) for k, p in params.items()}, st,
                   params)
    state = {"params": params, "opt": st}
    want = {"params": {k: p.clone() for k, p in params.items()},
            "opt": AdamWState(
                step=st.step, m={k: t.clone() for k, t in st.m.items()},
                v={k: t.clone() for k, t in st.v.items()},
                master={k: t.clone() for k, t in st.master.items()})}
    go, real = threading.Event(), np.savez

    def held(*a, **k):
        assert go.wait(30), "the in-place step never ran"
        return real(*a, **k)

    monkeypatch.setattr(np, "savez", held)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    opt.update({k: torch.full_like(p, 3.0) for k, p in params.items()}, st,
               params)
    assert st.step == 3 and not torch.equal(params["w"],
                                            want["params"]["w"])
    go.set()
    mgr.wait()
    fresh = {"params": {k: torch.zeros_like(p) for k, p in params.items()},
             "opt": opt.init({k: torch.zeros_like(p)
                              for k, p in params.items()})}
    got = mgr.restore(fresh)
    assert got["opt"].step == 2
    for k in params:
        for g, w in ((got["params"], want["params"]), (got["opt"].m,
                     want["opt"].m), (got["opt"].v, want["opt"].v),
                     (got["opt"].master, want["opt"].master)):
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def test_no_partial_checkpoint_visible(tmp_path, rng):
    """tmp dirs are never listed as checkpoints."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_99.tmp")
    assert mgr.all_steps() == []
    mgr.save(1, _tree(rng), blocking=True)
    assert mgr.all_steps() == [1]


def test_restore_missing_leaf_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(2)}, blocking=True)
    with pytest.raises(KeyError):
        mgr.restore({"a": torch.zeros(2), "b": torch.zeros(3)})


@pytest.mark.parametrize("where", ["wait", "next_save"])
def test_async_save_error_propagates(tmp_path, monkeypatch, where):
    """A failed background write must surface at the next sync point —
    wait() or the following save() — not vanish with the daemon thread;
    the manager is usable again once the error has been delivered."""
    mgr = CheckpointManager(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(np, "savez", boom)
    mgr.save(1, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="disk full"):
        if where == "wait":
            mgr.wait()
        else:
            mgr.save(2, {"a": torch.zeros(2)})
    monkeypatch.undo()
    mgr.save(3, {"a": torch.zeros(2)})
    mgr.wait()
    assert mgr.latest_step() == 3


def test_restore_corrupt_arrays_clear_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"a": torch.zeros(2)}, blocking=True)
    with open(tmp_path / "step_3" / "arrays.npz", "wb") as f:
        f.write(b"this is not an npz archive")
    with pytest.raises(ValueError, match="corrupt"):
        mgr.restore({"a": torch.zeros(2)}, step=3)


def test_restore_missing_arrays_file_clear_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, {"a": torch.zeros(2)}, blocking=True)
    os.remove(tmp_path / "step_4" / "arrays.npz")
    with pytest.raises(FileNotFoundError, match="no arrays.npz"):
        mgr.restore({"a": torch.zeros(2)}, step=4)


def test_read_meta_unpublished_step_clear_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(2)}, blocking=True)
    with pytest.raises(FileNotFoundError, match="never published"):
        mgr.read_meta(99)


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(2)}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"a": torch.zeros(3)})
