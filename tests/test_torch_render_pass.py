"""The port's test-time pass (``ops/render_pass.render_pass`` on CPU tensors,
i.e. its plain version ``render_pass_ref``) against the JAX package's
``render_pass_fused``, whose Pallas kernel runs in interpret mode on the CPU
backend.

Covers the four variants (sigma-only coarse / full fine, with and without
the NoF warp), fp32 and bf16, a ragged ray count, annealing weights below
one and the zero-frequency (raw xyz) quirk. Tolerances: fp32 1e-5 (measured
max |diff| 6e-8); bf16 1e-4, as in test_torch_nn.py (measured 6e-8: the
plain version rounds where ``_nof_tile``/``_nerf_tile`` round).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.nn.nerf import NeRFConfig as JNeRFConfig, init_nerf
from moco_flow_tpu.nn.nof import NoFConfig as JNoFConfig, init_nof
from moco_flow_tpu.ops.megakernel import render_pass_fused
from moco_flow_tpu.render.volume import EmbeddingSpec as JSpec
from moco_flow_tpu.render.volume import embed_padded as j_embed
from moco_flow_tpu_torch.nn.nerf import NeRFConfig
from moco_flow_tpu_torch.nn.nof import NoFConfig
from moco_flow_tpu_torch.ops.render_pass import render_pass
from moco_flow_tpu_torch.train.checkpoint import params_from_jax

NERF = dict(depth=4, width=64, in_channels_xyz=27, skips=(2,),
            extra_feat_type="ind", extra_feat_dim=5)
NOF = dict(depth=4, width=32, in_channels_xyz=21, skips=(2,),
           extra_feat_dim=21, use_quat=True)
TOL = {"fp32": 1e-5, "bf16": 1e-4}


@pytest.fixture(scope="module")
def setup():
    k = jax.random.split(jax.random.key(0), 2)
    params = {"coarse_NeRF": init_nerf(k[0], JNeRFConfig(**NERF)),
              "bw_NoF": init_nof(k[1], JNoFConfig(**NOF))}
    rng = np.random.default_rng(0)
    n, s = 7, 16
    o = (np.tile([0.0, 0.0, 3.0], (n, 1))
         + rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (-np.abs(d) / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)
    z = np.sort(rng.uniform(2, 4, (n, s)), -1).astype(np.float32)
    ind = jnp.asarray(rng.uniform(-1, 1, (n, 1)).astype(np.float32))
    extra = np.array(j_embed(ind, JSpec(2, in_channels=1), 5))
    ind_emb = np.array(j_embed(ind, JSpec(3, in_channels=1), 21))
    anneal = (np.array([1.0, 1.0, 0.6, 0.0], np.float32),
              np.array([1.0, 0.5, 0.0], np.float32))
    return params, o, d, z, extra, ind_emb, anneal


def _both(setup, use_nof, sigma_only, dt, nerf_freqs=4, nof_freqs=3,
          anneal=True):
    params, o, d, z, extra, ind_emb, (an_n, an_f) = setup
    jcfg_n, jcfg_f = JNeRFConfig(**NERF), JNoFConfig(**NOF)
    a_n = an_n if (anneal and nerf_freqs) else None
    a_f = an_f if (anneal and nof_freqs) else None
    want = render_pass_fused(
        params, "coarse_NeRF", jcfg_n, jcfg_f, nerf_freqs, nof_freqs, True,
        True, None if a_n is None else jnp.asarray(a_n),
        None if a_f is None else jnp.asarray(a_f), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(z),
        None if sigma_only else jnp.asarray(extra), jnp.asarray(ind_emb),
        use_nof, sigma_only, jnp.bfloat16 if dt == "bf16" else None)
    t = torch.from_numpy
    got = render_pass(
        params_from_jax(params), "coarse_NeRF", NeRFConfig(**NERF),
        NoFConfig(**NOF), nerf_freqs, nof_freqs, True, True,
        None if a_n is None else t(a_n), None if a_f is None else t(a_f),
        t(o), t(d), t(z), None if sigma_only else t(extra), t(ind_emb),
        use_nof, sigma_only, torch.bfloat16 if dt == "bf16" else None)
    return want, got


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("use_nof", [True, False], ids=["nof", "cano"])
@pytest.mark.parametrize("sigma_only", [True, False], ids=["coarse", "fine"])
def test_render_pass_matches_jax(setup, use_nof, sigma_only, dt):
    (js, jr), (ts, tr) = _both(setup, use_nof, sigma_only, dt)
    n, s = setup[3].shape
    assert ts.shape == (n, s) and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL[dt],
                               rtol=TOL[dt])
    if sigma_only:
        assert tr is None
    else:
        assert tr.shape == (3, n, s)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=TOL[dt],
                                   rtol=TOL[dt])


def test_render_pass_full_anneal_and_raw_xyz(setup):
    """No annealing (weights None), and n_freqs == 0: the raw-xyz quirk of
    the reference's init configs, run as a 1-frequency pass with zero
    sin/cos rows on both sides."""
    for kw in (dict(anneal=False), dict(nerf_freqs=0, nof_freqs=0)):
        (js, jr), (ts, tr) = _both(setup, True, False, "fp32", **kw)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                                   rtol=1e-5, err_msg=str(kw))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                                   rtol=1e-5, err_msg=str(kw))


def test_render_pass_rejects_other_devices(setup):
    params, o, d, z, extra, ind_emb, _ = setup
    meta = torch.empty(z.shape, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        render_pass(params_from_jax(params), "coarse_NeRF",
                    NeRFConfig(**NERF), NoFConfig(**NOF), 4, 3, True, True,
                    None, None, torch.from_numpy(o), torch.from_numpy(d),
                    meta, None, torch.from_numpy(ind_emb), True, True)
