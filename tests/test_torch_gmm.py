"""The port's scikit-learn-free sex model against wisecondorx_tpu.ops.gmm
(sklearn GaussianMixture), seed for seed: genders and the cutoff equal,
means and weights to rtol 1e-9, on separated, overlapping and fully
separated (plateau-fix) cohorts; and newref's --seed reaching the model
through both CLIs."""

import numpy as np
import pytest

from wisecondorx_tpu.ops import gmm as jgmm
from wisecondorx_tpu_torch.ops import gmm as tgmm

KINDS = ["separated", "overlapping", "plateau"]


def _samples(y_fractions):
    """Minimal sample dicts with the given chrY read fractions."""
    return [{"1": np.array([1e6 * (1 - y)]), "24": np.array([1e6 * y])}
            for y in y_fractions]


def _cohort(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "separated":
        f = rng.normal(4e-4, 1.5e-4, 40)
        m = rng.normal(9e-3, 8e-4, 35)
    elif kind == "overlapping":
        f = rng.normal(3e-3, 1.2e-3, 40)
        m = rng.normal(8e-3, 1.5e-3, 35)
    else:  # the mixture density underflows between the modes
        f = rng.normal(5e-4, 1e-4, 40)
        m = rng.normal(1.2e-2, 1e-4, 35)
    return _samples(np.abs(np.concatenate([f, m])))


def _assert_same_model(samples, random_state):
    want_g, want_cut, want_fit = jgmm.train_gender_model(
        samples, random_state=random_state)
    got_g, got_cut, got_fit = tgmm.train_gender_model(
        samples, random_state=random_state)
    assert got_g == want_g
    assert got_cut == want_cut
    for key in ("means", "weights"):
        np.testing.assert_allclose(got_fit[key], want_fit[key], rtol=1e-9,
                                   err_msg=key)
    return want_fit


@pytest.mark.parametrize("kind", KINDS)
def test_gender_model_matches_sklearn(kind):
    want_fit = _assert_same_model(_cohort(kind), 0)
    if kind == "plateau":
        interior = want_fit["density"][1:-1]
        assert not ((interior < want_fit["density"][:-2])
                    & (interior < want_fit["density"][2:])).any()


@pytest.mark.parametrize("random_state", range(5))
@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("kind", KINDS)
def test_gender_model_seed_for_seed(kind, seed, random_state):
    _assert_same_model(_cohort(kind, seed), random_state)


def test_overlapping_seed29_cutoff_follows_the_kmeans_start():
    """The cohort where an exact 2-means start lands one grid step away
    from sklearn's k-means++ start with random_state 0."""
    samples = _cohort("overlapping", seed=29)
    _assert_same_model(samples, 0)
    assert round(tgmm.train_gender_model(samples, random_state=0)[1], 7) == 0.0054771


def test_random_state_none_draws_from_the_global_generator():
    samples = _cohort("overlapping", seed=29)
    np.random.seed(4)
    want = jgmm.train_gender_model(samples, random_state=None)
    np.random.seed(4)
    got = tgmm.train_gender_model(samples, random_state=None)
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_allclose(got[2]["means"], want[2]["means"], rtol=1e-9)


def test_yfrac_override_and_predict_gender():
    samples = _cohort("separated")
    genders, cutoff, _ = tgmm.train_gender_model(samples, yfrac_override=0.005)
    assert cutoff == 0.005
    assert genders == jgmm.train_gender_model(samples, yfrac_override=0.005)[0]
    assert tgmm.predict_gender(samples[-1], cutoff) == "M"
    assert tgmm.predict_gender(samples[0], cutoff) == "F"


@pytest.fixture(scope="module")
def slice_cohort(tmp_path_factory):
    from synthetic import CohortSim
    from wisecondorx_tpu.io import npz as io_npz

    tmp = tmp_path_factory.mktemp("gmm_cli")
    samples, _ = CohortSim(binsize=1e5, genome_scale=0.02, seed=6).cohort(16, 14)
    infiles = []
    for i, s in enumerate(samples):
        path = tmp / f"control_{i}.npz"
        io_npz.save_sample_npz(path, 100000, s, {"mapped": 1})
        infiles.append(str(path))
    return tmp, infiles


def _recording(monkeypatch, gmm, reference):
    """Wrap a package's ``train_gender_model`` to record each call's seed
    and fit: in its gmm module (which ``--plotyfrac`` imports it from when
    it runs) and in its models.reference module (newref's import)."""
    calls = []
    real = gmm.train_gender_model

    def wrapper(samples, *args, **kwargs):
        out = real(samples, *args, **kwargs)
        calls.append((kwargs.get("random_state"), out))
        return out

    for module in (gmm, reference):
        monkeypatch.setattr(module, "train_gender_model", wrapper)
    return calls


@pytest.mark.parametrize("flag", ["newref", "plotyfrac"])
def test_cli_seed_reaches_the_sex_model(slice_cohort, flag, tmp_path,
                                        monkeypatch):
    """``newref --seed 3`` stores the same trained_cutoff in both packages'
    references, and ``--plotyfrac --seed 3`` draws the same fit."""
    from wisecondorx_tpu.cli import main as jax_cli
    from wisecondorx_tpu.models import reference as jref
    from wisecondorx_tpu_torch.cli import main as torch_cli
    from wisecondorx_tpu_torch.models import reference as tref

    _, infiles = slice_cohort
    calls = {"jax": _recording(monkeypatch, jgmm, jref),
             "torch": _recording(monkeypatch, tgmm, tref)}
    refs = {}
    for name, cli, extra in (("jax", jax_cli, []),
                             ("torch", torch_cli, ["--device", "cpu"])):
        refs[name] = str(tmp_path / f"{name}_ref.npz")
        args = ["newref", *infiles, refs[name], "--refsize", "40",
                "--seed", "3", *extra]
        if flag == "plotyfrac":
            with pytest.raises(SystemExit) as exc:
                cli(args + ["--plotyfrac", str(tmp_path / f"{name}.png")])
            assert exc.value.code == 0
        else:
            cli(args)
    assert [c[0] for c in calls["jax"]] == [c[0] for c in calls["torch"]] == [3]
    (_, (want_g, want_cut, want_fit)), = calls["jax"]
    (_, (got_g, got_cut, got_fit)), = calls["torch"]
    assert got_g == want_g and got_cut == want_cut
    for key in ("means", "weights", "y_fractions"):
        np.testing.assert_allclose(got_fit[key], want_fit[key], rtol=1e-9)
    np.testing.assert_allclose(got_fit["density"], want_fit["density"],
                               rtol=1e-9, atol=1e-300)
    if flag == "newref":
        cutoffs = [float(np.load(ref, allow_pickle=True)["trained_cutoff"])
                   for ref in refs.values()]
        assert cutoffs[0] == cutoffs[1] == want_cut
