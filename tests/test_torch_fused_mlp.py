"""The port's per-op MLPs (``mlp_impl: pallas``, kernels #8 and #9) against
the JAX package: ``moco_flow_tpu_torch/ops/fused_mlp.py`` against
``moco_flow_tpu/ops/fused_mlp.py`` (its Pallas kernels run interpreted on
the CPU), and the concatenating ``nerf_apply`` / ``nof_apply`` their
backwards recompute through.

Small widths: NeRF D=4 W=32 skip 2 (27 embedded inputs, a ``dir`` extra of
9), NoF D=3 W=16 skip 2 (21 + 9 inputs); n = 1500 rows, not a multiple of
JAX's 1024-row tiles. Inputs come from numpy seeds and the parameters from
the JAX initialisers, through ``params_from_jax``.

Tolerances. fp32: 1e-5 abs + 1e-5 rel (the packages sum in other orders;
measured max |diff| below 1e-6). bf16: 1e-4 abs + 1e-3 rel, the bound of
``tests/test_torch_nn.py`` (both round the same operands at the same
points; only a flipped rounding in another summation order differs), which
stays below the bf16-vs-fp32 gap of the JAX kernel itself, checked here.
Gradients (params, x, extra; inputs, xyz) against ``jax.grad`` of
``nerf_fused`` / ``nof_fused``, whose custom VJP recomputes through the plain
MLP, as the port's does: fp32 1e-5 of the tensor's largest magnitude + 1e-4
rel (sums over 1500 rows). bf16: the two frameworks round the cotangents at
other points (JAX's transposed bf16 products emit bf16, torch's autograd
multiplies in fp32 and rounds at the casts), so each gradient tensor may
differ from JAX's bf16 one by no more than JAX's bf16 gradient differs from
JAX's fp32 one on the same inputs (max and mean |diff|), the gap of bf16's
own rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.nn.nerf import (NeRFConfig as JNeRFConfig, init_nerf,
                                   nerf_apply as j_nerf_apply)
from moco_flow_tpu.nn.nof import (NoFConfig as JNoFConfig, init_nof,
                                  nof_apply as j_nof_apply)
from moco_flow_tpu.ops import fused_mlp as jfm
from moco_flow_tpu_torch.nn.nerf import NeRFConfig, nerf_apply
from moco_flow_tpu_torch.nn.nof import NoFConfig, nof_apply
from moco_flow_tpu_torch.ops import fused_mlp as fm
from moco_flow_tpu_torch.train.checkpoint import (_flatten, _unflatten,
                                                params_from_jax)

NERF = dict(depth=4, width=32, in_channels_xyz=27, skips=(2,),
            extra_feat_type="dir", extra_feat_dim=9)
NERF_NONE = dict(NERF, extra_feat_type="none", extra_feat_dim=0)
NOF = dict(depth=3, width=16, in_channels_xyz=21, skips=(2,),
           extra_feat_dim=9)
N = 1500
DTYPES = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": (1e-5, 1e-5), "bf16": (1e-4, 1e-3)}
GRAD_TOL = (1e-5, 1e-4)
_HEADS = ("final/", "extra/", "rgb/")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, atol, rtol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    jn = init_nerf(jax.random.key(0), JNeRFConfig(**NERF))
    jn0 = init_nerf(jax.random.key(2), JNeRFConfig(**NERF_NONE))
    jf = init_nof(jax.random.key(1), JNoFConfig(**NOF))
    jq = init_nof(jax.random.key(3), JNoFConfig(**NOF, use_quat=False))
    # sharpen the quaternion head so the rotation is far from identity
    jf["head"]["w"] = jf["head"]["w"] * 4.0
    arrs = {
        "x": rng.normal(size=(N, 27)).astype(np.float32),
        "extra": rng.normal(size=(N, 9)).astype(np.float32),
        "inputs": rng.normal(size=(N, 30)).astype(np.float32),
        "xyz": rng.normal(size=(N, 3)).astype(np.float32),
    }
    return {"jax": {"dir": jn, "none": jn0, "quat": jf, "offset": jq},
            "torch": {k: params_from_jax(v) for k, v in
                      {"dir": jn, "none": jn0, "quat": jf,
                       "offset": jq}.items()},
            "arrs": arrs}


def _nerf_case(data, kind):
    cfgs = {"dir": NERF, "none": NERF_NONE}
    return (JNeRFConfig(**cfgs[kind]), NeRFConfig(**cfgs[kind]),
            data["jax"][kind], data["torch"][kind])


def _nof_case(data, head):
    kw = dict(NOF, use_quat=head == "quat")
    return (JNoFConfig(**kw), NoFConfig(**kw), data["jax"][head],
            data["torch"][head])


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("kind,sigma_only", [("dir", False), ("none", False),
                                             ("dir", True)])
def test_nerf_plain_matches_pallas_kernel(data, kind, sigma_only, dname):
    """#8's plain version against JAX's ``_nerf_pallas`` (interpreted)."""
    jcfg, cfg, jp, tp = _nerf_case(data, kind)
    a = data["arrs"]
    jdt, tdt = DTYPES[dname]
    has_extra = kind == "dir" and not sigma_only
    want = jfm._nerf_pallas(jp, jcfg, jnp.asarray(a["x"]),
                            jnp.asarray(a["extra"]) if has_extra else None,
                            sigma_only, jdt)
    ws = fm._nerf_weights_flat(tp, sigma_only)
    got = fm.nerf_pallas(cfg, tdt, _t(a["x"]),
                         _t(a["extra"]) if has_extra else None, sigma_only,
                         ws)
    assert tuple(got.shape) == (N, 1 if sigma_only else 4)
    _close(got, _np(want), *TOL[dname], f"{kind} {sigma_only} {dname}")


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("head", ["quat", "offset"])
def test_nof_plain_matches_pallas_kernel(data, head, dname):
    """#9's plain version against JAX's ``_nof_pallas`` (interpreted)."""
    jcfg, cfg, jp, tp = _nof_case(data, head)
    a = data["arrs"]
    jdt, tdt = DTYPES[dname]
    want = jfm._nof_pallas(jp, jcfg, jnp.asarray(a["inputs"]),
                           jnp.asarray(a["xyz"]), jdt)
    got = fm.nof_pallas(cfg, tdt, _t(a["inputs"]), _t(a["xyz"]),
                        fm._nof_weights_flat(tp))
    _close(got, _np(want), *TOL[dname], f"{head} {dname}")
    if head == "quat":       # the head really rotates: far from x + t
        assert np.abs(_np(want) - a["xyz"]).mean() > 0.1


def test_bf16_tolerance_below_the_kernels_own_gap(data):
    jcfg, _, jp, _ = _nerf_case(data, "dir")
    a = data["arrs"]
    args = (jnp.asarray(a["x"]), jnp.asarray(a["extra"]), False)
    gap = np.abs(_np(jfm._nerf_pallas(jp, jcfg, *args, jnp.bfloat16))
                 - _np(jfm._nerf_pallas(jp, jcfg, *args, None))).max()
    assert gap > 10 * TOL["bf16"][0]


@pytest.mark.parametrize("dname", DTYPES)
def test_nerf_apply_matches_jax(data, dname):
    jcfg, cfg, jp, tp = _nerf_case(data, "dir")
    a = data["arrs"]
    jdt, tdt = DTYPES[dname]
    want = j_nerf_apply(jp, jnp.asarray(a["x"]), jnp.asarray(a["extra"]),
                        jcfg, jdt)
    got = nerf_apply(tp, _t(a["x"]), _t(a["extra"]), cfg, tdt)
    _close(got, _np(want), *TOL[dname])


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("head", ["quat", "offset"])
def test_nof_apply_matches_jax(data, head, dname):
    jcfg, cfg, jp, tp = _nof_case(data, head)
    a = data["arrs"]
    jdt, tdt = DTYPES[dname]
    want = j_nof_apply(jp, jnp.asarray(a["inputs"]), jnp.asarray(a["xyz"]),
                       jcfg, jdt)
    got = nof_apply(tp, _t(a["inputs"]), _t(a["xyz"]), cfg, tdt)
    _close(got, _np(want), *TOL[dname])


def _grad_close(got: dict, want: dict, want32: dict | None):
    """fp32 (``want32`` None): GRAD_TOL; bf16: within the gap between
    JAX's bf16 and fp32 gradients."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        if want32 is None:
            _close(g, w, GRAD_TOL[0] * scale, GRAD_TOL[1], k)
            continue
        # a gradient bf16 leaves exact (a bias of a head) is held to fp32's
        gap = np.maximum(np.abs(w - want32[k]), GRAD_TOL[0] * scale)
        err = np.abs(g - w)
        assert err.max() <= gap.max() and err.mean() <= gap.mean(), (
            f"{k}: max|diff| {err.max():.3e} mean {err.mean():.3e}, bf16 "
            f"gap max {gap.max():.3e} mean {gap.mean():.3e}")


def _flat_grads(grads) -> dict:
    """{name: numpy} of JAX's (params, a, b) gradients."""
    out = {k: _np(v) for k, v in _flatten(grads[0]).items()}
    out.update({"in0": _np(grads[1]), "in1": _np(grads[2])})
    return out


def _torch_grads(fn, params: dict, a, b) -> dict:
    """{name: grad} of sum(fn(params, a, b)) with every leaf a fresh
    tensor (a parameter it does not reach gets a zero gradient)."""
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in _flatten(params, leaf=lambda t: t).items()}
    ins = [_t(v).requires_grad_(True) for v in (a, b)]
    torch.sum(fn(_unflatten(leaves), *ins)).backward()
    out = {k: t.grad if t.grad is not None else torch.zeros_like(t)
           for k, t in leaves.items()}
    out.update({f"in{i}": t.grad if t.grad is not None else
                torch.zeros_like(t) for i, t in enumerate(ins)})
    return out


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("sigma_only", [False, True])
def test_nerf_fused_grads_match_jax(data, sigma_only, dname):
    """``_NerfFusedVjp``: the gradient of sum(out * c) through nerf_fused
    to every parameter, x and extra, against jax.grad."""
    jcfg, cfg, jp, tp = _nerf_case(data, "dir")
    a = data["arrs"]
    c = np.random.default_rng(5).normal(
        size=(N, 1 if sigma_only else 4)).astype(np.float32)

    def jgrads(jdt):
        def loss(p, x, e):
            return jnp.sum(jfm.nerf_fused(p, jcfg, x, e, sigma_only,
                                          compute_dtype=jdt) * c)
        return _flat_grads(jax.grad(loss, argnums=(0, 1, 2))(
            jp, jnp.asarray(a["x"]), jnp.asarray(a["extra"])))

    got = _torch_grads(lambda p, x, e: fm.nerf_fused(
        p, cfg, x, e, sigma_only, compute_dtype=DTYPES[dname][1]) * _t(c),
        tp, a["x"], a["extra"])
    want = jgrads(DTYPES[dname][0])
    if sigma_only:   # no gradient reaches the rgb branch or the extra
        for k in [k for k in want if k.startswith(_HEADS) or k == "in1"]:
            assert not np.abs(want.pop(k)).any() and not got.pop(k).any(), k
    _grad_close(got, want, None if dname == "fp32" else {
        k: v for k, v in jgrads(None).items() if k in want})


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("head", ["quat", "offset"])
def test_nof_fused_grads_match_jax(data, head, dname):
    """``_NofFusedVjp``: gradients to every parameter, inputs and xyz."""
    jcfg, cfg, jp, tp = _nof_case(data, head)
    a = data["arrs"]
    c = np.random.default_rng(6).normal(size=(N, 3)).astype(np.float32)

    def jgrads(jdt):
        def loss(p, i, x):
            return jnp.sum(jfm.nof_fused(p, jcfg, i, x,
                                         compute_dtype=jdt) * c)
        return _flat_grads(jax.grad(loss, argnums=(0, 1, 2))(
            jp, jnp.asarray(a["inputs"]), jnp.asarray(a["xyz"])))

    got = _torch_grads(lambda p, i, x: fm.nof_fused(
        p, cfg, i, x, compute_dtype=DTYPES[dname][1]) * _t(c),
        tp, a["inputs"], a["xyz"])
    _grad_close(got, jgrads(DTYPES[dname][0]),
                None if dname == "fp32" else jgrads(None))


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu(data):
    """A CPU tensor runs the plain version and counts no launch; a tensor
    of a device without a kernel raises."""
    _, cfg, _, tp = _nerf_case(data, "dir")
    a = data["arrs"]
    before = fm.nerf_pallas.launches, fm.nof_pallas.launches
    fm.nerf_pallas(cfg, None, _t(a["x"]), _t(a["extra"]), False,
                   fm._nerf_weights_flat(tp, False))
    assert (fm.nerf_pallas.launches, fm.nof_pallas.launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        fm.nerf_pallas(cfg, None, _t(a["x"]).to("meta"), None, True,
                       fm._nerf_weights_flat(tp, True))
