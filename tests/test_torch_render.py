"""The port's test-time ``render_rays`` against the JAX package's
``render_rays(..., mlp_impl="fused", test_time=True)``, and the golden
fixture that carries JAX's numbers to machines without JAX.

The model, rays and render cases are those of
``scripts/make_torch_port_golden.py`` (NeRF 4x48 coarse + fine, bw-NoF 4x32,
13 rays, annealing below one): exact fp32 and bf16, the canonical (no NoF)
render, and a cut fine budget with a coarse probe. JAX renders them afresh
here; the fixture must still hold those numbers, and the port must match.

Tolerances: fp32 1e-5 and bf16 1e-4, as in test_torch_nn.py. The cut budget
keeps the same samples on both sides because ``compact_fine_samples`` sorts
stably, like ``lax.sort``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu_torch.data.draws import Draws
from moco_flow_tpu_torch.render.volume import RenderConfig, render_rays
from moco_flow_tpu_torch.train.checkpoint import _unflatten, params_from_jax
from moco_flow_tpu_torch.train.factory import build_statics
from scripts.make_torch_port_golden import CASES, FIXTURE, MODEL_CFG, golden_arrays

TOL = {"float32": 1e-5, "bfloat16": 1e-4}


@pytest.fixture(scope="module")
def fresh():
    return golden_arrays()


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def _render(arrs, case: dict) -> dict:
    params = params_from_jax(_unflatten(
        {k[len("params/"):]: v for k, v in arrs.items()
         if k.startswith("params/")}))
    anneal = {k[len("anneal/"):]: torch.from_numpy(v)
              for k, v in arrs.items() if k.startswith("anneal/")}
    rcfg = RenderConfig(n_samples=MODEL_CFG["N_samples"],
                        n_importance=MODEL_CFG["N_importance"],
                        test_time=True, **case)
    out = render_rays(params, build_statics(MODEL_CFG), anneal,
                      torch.from_numpy(arrs["rays"]),
                      torch.from_numpy(arrs["background"]), rcfg)
    return {k: v.numpy() for k, v in out.items()}


def test_fixture_still_matches_jax(fresh, stored):
    assert set(fresh) == set(stored)
    for k in fresh:
        if k == "config_json":
            assert str(fresh[k]) == str(stored[k])
        else:
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_fixture_is_not_trivial(stored, name):
    """Rays that stop and rays that pass, so the fine render is neither the
    background nor one sample's colour everywhere."""
    opacity = stored[f"out/{name}/opacity_fine"]
    assert opacity.min() < 0.5 < opacity.max()
    rgb_vs_bg = np.abs(stored[f"out/{name}/rgb_fine"] - stored["background"])
    assert rgb_vs_bg.max() > 0.1


@pytest.mark.parametrize("name", list(CASES))
def test_render_rays_matches_jax(fresh, name):
    case = CASES[name]
    got = _render(fresh, case)
    want = {k.split("/")[-1]: v for k, v in fresh.items()
            if k.startswith(f"out/{name}/")}
    assert set(got) == set(want)
    tol = TOL[case["compute_dtype"]]
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=f"{name}/{k}")


def test_fine_budget_and_probe(stored):
    """A full fine budget and a probe of every coarse depth reproduce the
    exact render bit for bit; a cut budget stays within the bound the JAX
    package's own test uses (test_megakernel.py)."""
    exact = _render(stored, CASES["fp32"])
    full = MODEL_CFG["N_samples"] + MODEL_CFG["N_importance"]
    for over in ({"fine_budget": full},
                 {"coarse_probe": MODEL_CFG["N_samples"]}):
        got = _render(stored, dict(CASES["fp32"], **over))
        for k in exact:
            np.testing.assert_array_equal(got[k], exact[k],
                                          err_msg=f"{over} {k}")
    cut = _render(stored, dict(CASES["fp32"], fine_budget=24))
    assert np.abs(cut["rgb_fine"] - exact["rgb_fine"]).max() < 3e-2


def test_training_branch_raises(stored):
    """The training render with the NoF but no warp chain (the val step's,
    through the single-warp NoF kernel) runs, and with sigma noise from its
    Draws (zero noise gives the noiseless render's bits); what it lacks
    raises: sigma noise without the Draws' noise, and a perturbed render
    without its Draws (the chained branch is tests/test_torch_train_render.py,
    the val step tests/test_torch_train_phases.py)."""
    params = params_from_jax(_unflatten(
        {k[len("params/"):]: v for k, v in stored.items()
         if k.startswith("params/")}))
    anneal = {k[len("anneal/"):]: torch.from_numpy(v)
              for k, v in stored.items() if k.startswith("anneal/")}
    rays = torch.from_numpy(stored["rays"])
    bg = torch.from_numpy(stored["background"])
    n, s, i = rays.shape[0], MODEL_CFG["N_samples"], MODEL_CFG["N_importance"]
    statics = build_statics(MODEL_CFG)
    draws = Draws(frame=0, pixels=torch.zeros(n, dtype=torch.long),
                  background=torch.zeros(1, 3), chained=None,
                  perturb=torch.rand(n, s), pdf=torch.rand(n, i))

    def rcfg(**kw):
        return RenderConfig(n_samples=s, n_importance=i, use_nof=True,
                            test_time=False, **kw)

    out = render_rays(params, statics, anneal, rays, bg, rcfg(perturb=0.0))
    assert out["rgb_fine"].shape == (n, 3)
    assert torch.isfinite(out["rgb_fine"]).all()
    base = render_rays(params, statics, anneal, rays, bg, rcfg(perturb=1.0),
                       draws=draws)
    zero = render_rays(params, statics, anneal, rays, bg,
                       rcfg(perturb=1.0, noise_std=1.0),
                       draws=dataclasses.replace(
                           draws, sigma_noise_coarse=torch.zeros(n, s),
                           sigma_noise_fine=torch.zeros(n, s + i)))
    for k, v in base.items():
        torch.testing.assert_close(zero[k], v, rtol=0, atol=0)
    noised = render_rays(params, statics, anneal, rays, bg,
                         rcfg(perturb=1.0, noise_std=1.0),
                         draws=dataclasses.replace(
                             draws, sigma_noise_coarse=torch.randn(n, s),
                             sigma_noise_fine=torch.randn(n, s + i)))
    assert torch.isfinite(noised["rgb_fine"]).all()
    assert not torch.equal(noised["rgb_fine"], base["rgb_fine"])
    with pytest.raises(ValueError, match="sigma noise"):
        render_rays(params, statics, anneal, rays, bg,
                    rcfg(perturb=1.0, noise_std=1.0), draws=draws)
    with pytest.raises(ValueError, match="Draws"):
        render_rays(params, statics, anneal, rays, bg, rcfg(perturb=1.0))
