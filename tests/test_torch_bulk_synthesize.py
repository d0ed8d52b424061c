"""The port's bulk datagen (``python -m empose_tpu_torch.tools.bulk_synthesize``)
against the JAX tool (``tools/bulk_synthesize.py``) on the seeded corpus of
``tests/conftest.py`` (3 sequences of 40 frames), windows of 16, batch 2.

At ``--offset_noise_level -1`` the only random draw is each window's subject
(its mean offsets); the two packages' generators differ, so that comparison
runs with a bank of one subject in both (each package's
``get_all_offset_files`` replaced in the test). Tolerances are
``tests/test_torch_datagen.py``'s: the synthesized sensors and joints atol
5e-5, rtol 1e-5 (its FK_TOL: the two packages' FK and virtual sensors round
differently), the root-normalized poses atol 2e-5, rtol 1e-5; ids, frame
counts, betas, zero trans and the offsets exactly.
"""

import os

import numpy as np
import pytest

import empose_tpu.data.datasets as JD
from empose_tpu.data.emr import EMRReader as JEMRReader
from tools.bulk_synthesize import synthesize_corpus as j_synthesize

import empose_tpu_torch.tools.bulk_synthesize as B
from empose_tpu_torch.data.emr import EMRReader

EXACT = ("betas", "trans", "offset_t", "offset_r")
TOL = {"marker_pos": dict(atol=5e-5, rtol=1e-5), "marker_ori": dict(atol=5e-5, rtol=1e-5),
       "marker_nor": dict(atol=5e-5, rtol=1e-5), "joints": dict(atol=5e-5, rtol=1e-5),
       "poses": dict(atol=2e-5, rtol=1e-5)}
KW = dict(window=16, batch=2)


def _corpus(assets_dir):
    return os.path.join(assets_dir, "data_synth", "amass_emr")


def _records(path, reader=EMRReader):
    r = reader(path)
    return [(r.meta(i), {f: r.read(i, f) for f in r.fields(i)}) for i in range(len(r))]


def _one_subject(monkeypatch):
    for mod in (JD, B):
        full = mod.get_all_offset_files
        monkeypatch.setattr(mod, "get_all_offset_files",
                            lambda full=full: dict(sorted(full().items())[:1]))


@pytest.mark.parametrize("seed", [1, 4])
def test_records_match_jax_at_mean_offsets(assets_env, tmp_path, monkeypatch, seed):
    _one_subject(monkeypatch)
    want_path, got_path = str(tmp_path / "jax.emr"), str(tmp_path / "port.emr")
    n = j_synthesize(_corpus(assets_env), want_path, noise_level=-1, seed=seed, **KW)
    assert B.synthesize_corpus(_corpus(assets_env), got_path, noise_level=-1, seed=seed,
                               device="cpu", **KW) == n == 3
    want, got = _records(want_path, JEMRReader), _records(got_path)
    assert [m for m, _ in got] == [m for m, _ in want]
    for (meta, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w)
        for f in EXACT:
            assert np.array_equal(g[f], w[f]), (meta["id"], f)
        for f, tol in TOL.items():
            assert g[f].shape == w[f].shape, (meta["id"], f)
            np.testing.assert_allclose(g[f], w[f], err_msg=f"{meta} {f}", **tol)


def test_level_zero_draws_and_the_seed(assets_env, tmp_path):
    """At level 0 (one offset sample per window) the fields that do not
    draw equal the JAX tool's for the same seed (ids, frame counts, betas
    and zero trans exactly, poses and joints within the tolerances above),
    and each record's ``offset_t`` is a subject's mean offsets (the offsets
    assumed known downstream); another seed crops other windows."""
    want_path = str(tmp_path / "jax.emr")
    j_synthesize(_corpus(assets_env), want_path, noise_level=0, seed=1, **KW)
    paths = {s: str(tmp_path / f"port{s}.emr") for s in (1, 2)}
    for s, p in paths.items():
        B.synthesize_corpus(_corpus(assets_env), p, noise_level=0, seed=s, device="cpu", **KW)
    want, got = _records(want_path, JEMRReader), _records(paths[1])
    assert [m for m, _ in got] == [m for m, _ in want]
    means = [np.load(f)["means"].astype(np.float32) for f in B.get_all_offset_files().values()]
    for (meta, g), (_, w) in zip(got, want):
        assert np.array_equal(g["betas"], w["betas"]) and not g["trans"].any()
        for f in ("poses", "joints"):
            np.testing.assert_allclose(g[f], w[f], err_msg=f"{meta} {f}", **TOL[f])
        assert all(np.isfinite(g[f]).all() for f in TOL)
        assert any(np.array_equal(g["offset_t"], m) for m in means)
        assert g["marker_pos"].shape == w["marker_pos"].shape
    other = _records(paths[2])
    assert any(not np.allclose(a["poses"], b["poses"]) for (_, a), (_, b) in zip(got, other))


def test_dp_devices_equals_one(assets_env, tmp_path):
    """``--dp_devices 2`` over the CPU twice (batch 2 of 3 sequences: the
    last batch of one window padded to 2, the pad not written) writes the
    records of ``--dp_devices 1`` bit for bit, draws included."""
    paths = {n: str(tmp_path / f"dp{n}.emr") for n in (1, 2)}
    counts = {n: B.main(["--corpus", _corpus(assets_env), "--out", p, "--window", "16",
                         "--batch", "2", "--seed", "3", "--offset_noise_level", "1",
                         "--dp_devices", str(n), "--device", "cpu"])
              for n, p in paths.items()}
    assert counts == {1: 3, 2: 3}
    one, two = _records(paths[1]), _records(paths[2])
    assert [m for m, _ in one] == [m for m, _ in two]
    for (meta, a), (_, b) in zip(one, two):
        for f in a:
            assert np.array_equal(a[f], b[f]), (meta["id"], f)
