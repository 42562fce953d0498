"""The port's grain loader (yolo_tpu_torch/data/grain_pipeline.py, which
imports no grain) against the JAX package's, which runs grain 0.2.15:
  * tests/test_grain.py's non-slow tests rerun on the port (its
    grain_train_batches, AugmentConfig, train_batches and CLI in the
    place of the JAX package's);
  * the same pairs and seed give bit-equal batches (images and every
    target), plain and multi-scale; with augment, mosaic and mixup, and
    with worker_count=2 (worker processes, under a timeout of its own),
    bit-equal too where this host's cv2 converts HSV -> RGB in its AVX2
    build, which the port reproduces (else the images may differ by one
    level where the conversion does);
  * grain's (C++) index_shuffle value for value, at sizes whose walks
    are long (n - 1 < 2^16) and at n - 1 a power of two, and the
    sampler's checks;
  * the state after the same pulls equals JAX's, byte for byte; a state
    the JAX loader wrote restores the same next batch in the port; a
    state of another source, sampler or worker count is refused;
  * `train --loader grain` stopped after step 1 and --resume'd equals
    the uninterrupted run, and the JAX command's run on the same argv.
"""

import faulthandler
import json
import os

import numpy as np
import pytest

grain = pytest.importorskip("grain")

import tests.test_grain as jtg  # noqa: E402
from tests.test_grain import KW, _mk_pairs  # noqa: E402
from tests.test_torch_cli import files  # noqa: E402,F401  (fixture)
from tests.torch_port import PortCli, jax_test_names, rerun_jax_test  # noqa: E402,E501
from yolo_tpu.data import augment as jaug  # noqa: E402
from yolo_tpu.data import grain_pipeline as jgp  # noqa: E402
from yolo_tpu.data import pipeline as jpipe  # noqa: E402
from yolo_tpu_torch.data import augment as taug  # noqa: E402
from yolo_tpu_torch.data import grain_pipeline as tgp  # noqa: E402
from yolo_tpu_torch.data import pipeline as tpipe  # noqa: E402

JAX_CLI_TESTS = ("test_cli_grain_cfg_driven_mosaic_trains",
                 "test_multi_scale_flags_require_multi_scale")
JAX_TESTS = [n for n in jax_test_names(jtg)
             if not getattr(getattr(jtg, n.split(".")[0]), "pytestmark",
                            None)
             and n not in JAX_CLI_TESTS]


def _port(monkeypatch):
    """The JAX grain, augment and pipeline names the tests read, bound
    to the port's."""
    for mod in (jtg, jgp):
        monkeypatch.setattr(mod, "grain_train_batches",
                            tgp.grain_train_batches)
    monkeypatch.setattr(jgp, "MultiScaleGrainIterator",
                        tgp.MultiScaleGrainIterator)
    monkeypatch.setattr(jaug, "AugmentConfig", taug.AugmentConfig)
    monkeypatch.setattr(jpipe, "train_batches", tpipe.train_batches)


@pytest.mark.parametrize("name", JAX_TESTS)
def test_jax_grain_tests_hold_for_the_port(name, tmp_path, monkeypatch):
    _port(monkeypatch)
    rerun_jax_test(jtg, name, {"tmp_path": tmp_path})


@pytest.mark.parametrize("name", JAX_CLI_TESTS)
def test_jax_grain_cli_tests_hold_for_the_port(name, tmp_path, capsys,
                                               monkeypatch):
    import yolo_tpu
    import yolo_tpu.cli  # noqa: F401  (bound, then replaced)

    monkeypatch.setattr(yolo_tpu, "cli", PortCli)
    rerun_jax_test(jtg, name, {"tmp_path": tmp_path, "capsys": capsys})


def test_index_shuffle_is_grains():
    from grain._src.python.experimental.index_shuffle.python import (
        index_shuffle_module as cxx)

    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 7, 100, 65536, 65537, 300001):
        for seed in (0, 5, 2 ** 32 - 1):
            order = tgp._epoch_order(n, seed)
            for i in [n - 1, *rng.integers(0, n, 50)]:
                assert order[i] == cxx.index_shuffle(
                    int(i), max_index=n - 1, seed=seed, rounds=4)



def test_sampler_is_grains():
    import grain.python as gp

    want = gp.IndexSampler(num_records=7, shard_options=gp.NoSharding(),
                           shuffle=True, num_epochs=3, seed=5)
    got = tgp._IndexSampler(7, 3, 5)
    assert repr(got) == repr(want)
    for i in range(21):
        assert got.record_key(i) == want[i].record_key
        assert got.rng(i).integers(1 << 30) == want[i].rng.integers(1 << 30)
    for bad in (-1, 2 ** 32):
        with pytest.raises(ValueError, match="32-bit"):
            tgp._IndexSampler(7, 1, bad)
    with pytest.raises(ValueError, match="number of records"):
        tgp._IndexSampler(0, 1, 0)


def _equal_batches(a, b, hsv_levels=False):
    """Bit-equal batches. hsv_levels: augmented images, bit-equal where
    this host's cv2 converts HSV -> RGB in the AVX2 build the port
    reproduces; on another build they may differ where the conversion
    does (tests/test_torch_data.py: at most 0.1% of the pixels, by one
    level of 255), a level at most after the letterbox's weights or the
    mixup blend. Targets are always exact."""
    from tests.torch_port import cv2_hsv_is_avx2

    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            if hsv_levels and k == "images" and not cv2_hsv_is_avx2():
                diff = np.abs(x[k] - y[k])
                assert diff.max() <= 1 / 255 + 1e-7
                assert np.mean(diff > 0) <= 2e-3
                continue
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def _ladder(bi):
    return 64 if (bi // 2) % 2 == 0 else 96


MODES = {
    "plain": {},
    "augment": {"augment": {}},
    "mosaic": {"augment": {"mosaic": True}},
    "mixup": {"augment": {"mixup": True}},
    "multi_scale": {"size_for_batch": _ladder},
}


def _kw(mode, aug_mod):
    kw = dict(KW, num_epochs=2, seed=3)
    spec = MODES[mode]
    if "augment" in spec:
        kw["augment_cfg"] = aug_mod.AugmentConfig(**spec["augment"])
    if "size_for_batch" in spec:
        kw["size_for_batch"] = spec["size_for_batch"]
    return kw


@pytest.mark.parametrize("mode", list(MODES))
def test_batches_bit_equal_to_jax(mode, tmp_path):
    pairs = _mk_pairs(tmp_path)
    want = list(jgp.grain_train_batches(pairs, **_kw(mode, jaug)))
    got = list(tgp.grain_train_batches(pairs, **_kw(mode, taug)))
    assert len(got) == 6
    _equal_batches(got, want, hsv_levels="augment" in MODES[mode])


def test_worker_processes_bit_equal_to_jax(tmp_path):
    """worker_count=2 in both packages, augmented, with the state after
    three pulls and its restore in the port; the whole test is ended
    (the test process with it) if it runs past 240 s."""
    faulthandler.dump_traceback_later(240, exit=True)
    try:
        pairs = _mk_pairs(tmp_path, n=7)
        kw = dict(KW, num_epochs=2, seed=5, worker_count=2)
        jit = jgp.grain_train_batches(pairs, augment_cfg=jaug.AugmentConfig(),
                                      **kw)
        tit = tgp.grain_train_batches(pairs, augment_cfg=taug.AugmentConfig(),
                                      **kw)
        want = [next(jit) for _ in range(3)]
        got = [next(tit) for _ in range(3)]
        _equal_batches(got, want, hsv_levels=True)
        assert tit.get_state() == jit.get_state()
        state = json.loads(tit.get_state())
        assert state["last_worker_index"] == 0
        assert state["last_seen_indices"] == {"0": 6, "1": 3}
        want += list(jit)
        got += list(tit)
        _equal_batches(got, want, hsv_levels=True)
        assert len(want) == 6       # 7 records a worker, 3 batches each
        # a fresh port loader restored at pull 3 gives the same tail
        again = tgp.grain_train_batches(
            pairs, augment_cfg=taug.AugmentConfig(), **kw)
        again.set_state(tit.state_for_pull(3))
        _equal_batches(list(again), got[3:])
        for it in (tit, again):
            it.close()
    finally:
        faulthandler.cancel_dump_traceback_later()


def test_state_positions_equal_jax_and_cross_restore(tmp_path):
    pairs = _mk_pairs(tmp_path)
    jit = jgp.grain_train_batches(pairs, seed=9, num_epochs=2, **KW)
    tit = tgp.grain_train_batches(pairs, seed=9, num_epochs=2, **KW)
    assert tit.get_state() == jit.get_state()
    for _ in range(2):
        next(jit)
        next(tit)
    assert tit.get_state() == jit.get_state()
    assert json.loads(tit.get_state())["last_seen_indices"] == {"0": 3}
    # a state the JAX loader wrote restores the same next batch here
    fresh = tgp.grain_train_batches(pairs, seed=9, num_epochs=2, **KW)
    fresh.set_state(jit.get_state())
    _equal_batches([next(fresh)], [next(jit)])
    # and the other way round
    jfresh = jgp.grain_train_batches(pairs, seed=9, num_epochs=2, **KW)
    jfresh.set_state(fresh.get_state())
    _equal_batches([next(fresh)], [next(jfresh)])


def test_state_of_another_loader_is_refused(tmp_path):
    pairs = _mk_pairs(tmp_path)
    state = tgp.grain_train_batches(pairs, seed=1, **KW).get_state()
    for kw, what in (({"seed": 2}, "Sampler"),
                     ({"seed": 1, "worker_count": 1}, "Worker count")):
        it = tgp.grain_train_batches(pairs, **kw, **KW)
        with pytest.raises(ValueError, match=what):
            it.set_state(state)
    other = tgp.grain_train_batches(pairs[::-1], seed=1, **KW)
    with pytest.raises(ValueError, match="DataSource"):
        other.set_state(state)


def _grain_log(path):
    with open(path) as f:
        rows = [json.loads(l) for l in f if l.strip()]
    return {r["step"]: r for r in rows if "loss" in r}


def test_cli_grain_fail_resume_equals_uninterrupted_and_jax(files, tmp_path,
                                                            capsys):
    """train --loader grain over 2 epochs of the VOC fixture, stopped
    after step 1 and --resume'd: the resumed steps see the batches and
    losses of the uninterrupted run, the final state equals it, and the
    JAX command's fail-and-resume run on the same argv ends within the
    train tests' bound (STEP_TOL of each tensor's scale)."""
    import jax

    import yolo_tpu.cli as jcli
    import yolo_tpu_torch.cli as tcli
    from tests.test_torch_cli import (CPU, STEP_TOL, _train_argv,
                                      _tree_close)
    from yolo_tpu.io import checkpoint as jckpt
    from yolo_tpu_torch.io import checkpoint as ckpt

    runs = {}
    for tag, main, dev, fail in (("full", tcli.main, CPU, False),
                                 ("t", tcli.main, CPU, True),
                                 ("j", jcli.main, [], True)):
        ck = str(tmp_path / tag)
        argv = _train_argv(files, ck, "--loader", "grain", "--epochs", "2",
                           "--log-every", "1",
                           "--log-file", str(tmp_path / f"{tag}.jsonl"))
        argv += dev
        if fail:
            with pytest.raises(SystemExit, match="fail-after-step"):
                main(argv + ["--fail-after-step", "1"])
            assert os.path.exists(os.path.join(ck, "step_1.grain"))
            os.rename(tmp_path / f"{tag}.jsonl", tmp_path / f"{tag}0.jsonl")
            main(argv + ["--resume", os.path.join(ck, "step_1")])
            assert "restored grain data-iterator position" in \
                capsys.readouterr().err
        else:
            main(argv)
        runs[tag] = os.path.join(ck, "final")
    full, res = _grain_log(tmp_path / "full.jsonl"), \
        _grain_log(tmp_path / "t.jsonl")
    assert sorted(res) == sorted(full)[1:] and len(full) >= 3
    for step in res:
        assert res[step]["loss"] == full[step]["loss"], step
    want = ckpt.restore(runs["full"])
    got = ckpt.restore(runs["t"])
    assert got["step"] == want["step"] == len(full)
    _tree_close(want["params"], got["params"], 1e-6, "params")
    jwant = ckpt.from_numpy_state(jax.device_get(jckpt.restore(runs["j"])))
    assert jwant["step"] == got["step"] and jwant["seen"] == got["seen"]
    _tree_close(jwant["params"], got["params"], STEP_TOL, "params")
    assert os.path.exists(runs["t"] + ".grain")
    assert json.loads(open(runs["t"] + ".grain").read()) == \
        json.loads(open(runs["j"] + ".grain").read())
