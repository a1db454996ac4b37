"""The port's nn/ modules (moco_flow_tpu_torch/nn) against the JAX package.

Inputs come from numpy seeds; parameters are drawn with the JAX
initialisers and cross over through ``params_from_jax``, so both packages
compute from identical numbers.

Tolerances: fp32 1e-5 (the two packages sum in different orders; measured
max |diff| 2.4e-7). bf16 1e-4: both packages round the same operands to
bf16 at the same points and accumulate in fp32, so they differ only where a
different summation order flips a bf16 rounding (measured max |diff| 4.8e-7
at these shapes); 1e-4 stays 8x below the gap between bf16 and fp32 JAX
itself (7.8e-4, ``test_bf16_gap_dominates``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.nn import embedding as jemb
from moco_flow_tpu.nn import metrics as jmet
from moco_flow_tpu.nn import quaternion as jq
from moco_flow_tpu.nn.nerf import (NeRFConfig as JNeRFConfig, init_nerf,
                                   nerf_apply_perray_extra as j_apply,
                                   nerf_sigma as j_sigma)
from moco_flow_tpu.nn.nof import (NoFConfig as JNoFConfig, init_nof,
                                  nof_apply_split as j_nof)
from moco_flow_tpu_torch.nn import embedding as temb
from moco_flow_tpu_torch.nn import metrics as tmet
from moco_flow_tpu_torch.nn import quaternion as tq
from moco_flow_tpu_torch.nn.nerf import (NeRFConfig, nerf_apply_perray_extra,
                                         nerf_sigma)
from moco_flow_tpu_torch.nn.nof import NoFConfig, nof_apply_split
from moco_flow_tpu_torch.train.checkpoint import params_from_jax

NERF = dict(depth=4, width=64, in_channels_xyz=27, skips=(2,),
            extra_feat_type="ind", extra_feat_dim=5)
NOF = dict(depth=4, width=32, in_channels_xyz=21, skips=(2,),
           extra_feat_dim=21, use_quat=True)
N, S = 6, 8
# (jax dtype, torch dtype, atol) per compute dtype
DTYPES = {"fp32": (None, None, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16,
                                              1e-4)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    jn = init_nerf(jax.random.key(0), JNeRFConfig(**NERF))
    jf = init_nof(jax.random.key(1), JNoFConfig(**NOF))
    x_emb = rng.normal(size=(N * S, 27)).astype(np.float32)
    extra = rng.normal(size=(N, 5)).astype(np.float32)
    f_emb = rng.normal(size=(N * S, 21)).astype(np.float32)
    ind = rng.normal(size=(N, 21)).astype(np.float32)
    xyz = rng.normal(size=(N * S, 3)).astype(np.float32)
    return jn, jf, x_emb, extra, f_emb, ind, xyz


@pytest.mark.parametrize("n_freqs,logscale,weighted", [
    (4, True, False), (4, True, True), (10, True, True), (3, False, True),
    (0, True, False)])
def test_posenc(n_freqs, logscale, weighted):
    rng = np.random.default_rng(n_freqs)
    x = rng.normal(size=(7, 3)).astype(np.float32)
    w = rng.uniform(0, 1, n_freqs).astype(np.float32) if weighted else None
    want = jemb.posenc(jnp.asarray(x), n_freqs, logscale,
                       None if w is None else jnp.asarray(w))
    got = temb.posenc(_t(x), n_freqs, logscale, None if w is None else _t(w))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_freqs,logscale", [(16, True), (3, False)])
def test_posenc_bands_made_once(n_freqs, logscale, monkeypatch):
    """The bands of an embedding reach its device once (a copy from the
    host would wait for the device at every embedding of a step), and are
    the bands of ``freq_bands``."""
    calls = []
    real = temb.freq_bands
    monkeypatch.setattr(temb, "_BANDS", {})
    monkeypatch.setattr(temb, "freq_bands",
                        lambda *a: calls.append(a) or real(*a))
    x = torch.linspace(-1.0, 1.0, 12).reshape(4, 3)
    first = temb.posenc(x, n_freqs, logscale)
    again = temb.posenc(x, n_freqs, logscale)
    assert calls == [(n_freqs, logscale)]
    assert torch.equal(first, again)
    bands = temb.device_bands(n_freqs, logscale, x.device)
    assert bands is temb.device_bands(n_freqs, logscale, "cpu")
    np.testing.assert_array_equal(bands.numpy(), real(n_freqs, logscale))

@pytest.mark.parametrize("step", [0, 5000, 5001, 300000, 1004999, 1005000,
                                  2000000])
def test_anneal_weights(step):
    want = jemb.anneal_weights(jnp.asarray(step), 10, 5000, 1005000)
    got = temb.anneal_weights(step, 10, 5000, 1005000)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_nerf_sigma(nets, dt):
    jn, _, x_emb, *_ = nets
    jd, td, atol = DTYPES[dt]
    want = j_sigma(jn, jnp.asarray(x_emb), JNeRFConfig(**NERF), jd)
    got = nerf_sigma(params_from_jax(jn), _t(x_emb), NeRFConfig(**NERF), td)
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_nerf_apply_perray_extra(nets, dt):
    jn, _, x_emb, extra, *_ = nets
    jd, td, atol = DTYPES[dt]
    want = j_apply(jn, jnp.asarray(x_emb), jnp.asarray(extra), S,
                   JNeRFConfig(**NERF), jd)
    got = nerf_apply_perray_extra(params_from_jax(jn), _t(x_emb), _t(extra),
                                  S, NeRFConfig(**NERF), td)
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_nof_apply_split(nets, dt):
    _, jf, _, _, f_emb, ind, xyz = nets
    jd, td, atol = DTYPES[dt]
    want = j_nof(jf, jnp.asarray(f_emb), jnp.asarray(ind), S,
                 jnp.asarray(xyz), JNoFConfig(**NOF), jd)
    got = nof_apply_split(params_from_jax(jf), _t(f_emb), _t(ind), S,
                          _t(xyz), NoFConfig(**NOF), td)
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=atol,
                               rtol=atol)


def test_bf16_gap_dominates(nets):
    """The bf16 tolerance above is a port-vs-JAX bound, not bf16's own
    error: bf16 and fp32 JAX differ by far more."""
    jn, _, x_emb, extra, *_ = nets
    cfg = JNeRFConfig(**NERF)
    hi = j_apply(jn, jnp.asarray(x_emb), jnp.asarray(extra), S, cfg, None)
    lo = j_apply(jn, jnp.asarray(x_emb), jnp.asarray(extra), S, cfg,
                 jnp.bfloat16)
    got = nerf_apply_perray_extra(params_from_jax(jn), _t(x_emb), _t(extra),
                                  S, NeRFConfig(**NERF), torch.bfloat16)
    gap = np.abs(_np(lo) - _np(hi)).max()
    port = np.abs(got.float().numpy() - _np(lo)).max()
    assert port < gap, (port, gap)


def test_quaternion():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tq.quaternion_log_to_exp(_t(v)).numpy(),
        _np(jq.quaternion_log_to_exp(jnp.asarray(v))), rtol=1e-6, atol=1e-6)
    r = tq.log_quaternion_to_rotation_matrix(_t(v))
    np.testing.assert_allclose(
        r.numpy(), _np(jq.log_quaternion_to_rotation_matrix(jnp.asarray(v))),
        rtol=1e-5, atol=1e-6)
    eye = torch.eye(3).expand(32, 3, 3)
    np.testing.assert_allclose((r @ r.transpose(1, 2)).numpy(), eye.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("metric", ["psnr", "ssim", "dssim"])
def test_metrics(metric):
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (1, 3, 20, 24)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(
        np.float32)
    want = getattr(jmet, metric)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tmet, metric)(_t(a), _t(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
