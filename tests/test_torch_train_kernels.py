"""The training kernels' plain versions against the JAX package's fused
functions, forward and backward: the port's ``nerf_fused_rays_t`` and
``nof_chain_rays_t`` on CPU tensors (``_nerf_fwd_ref`` / ``_nerf_bwd_ref``
and ``_chain_fwd_ref`` / ``_chain_bwd_ref`` behind their autograd
Functions) against ``jax.grad`` through ``moco_flow_tpu.ops.megakernel``,
whose Pallas kernels run in interpret mode on the CPU backend.

Widths of tests/test_megakernel.py (NeRF 4x64 with the 5-dim frame feature,
NoF 4x32 with the quaternion head), 7 rays (ragged) x 12 samples, PE
annealing below one. The loss is a fixed random weighting of every output,
and the gradients are compared for every parameter leaf, the positions and
the frame embeddings.

Tolerances, relative to each array's largest magnitude: fp32 1e-5 (both
sides sum in fp32, in other orders; measured <= 4e-7). bf16 1e-4: the plain
versions round to bf16 where the JAX tiles round, so another summation
order is the only difference (measured <= 4e-7). The test also measures the
JAX package's own bf16-vs-fp32 gap on the same inputs (0.19 to 0.32 of the
scale for these widths) and checks that it is far above the bound, so the
bf16 cases do test bf16 rounding and not an fp32 computation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.nn.nerf import NeRFConfig as JNeRFConfig, init_nerf
from moco_flow_tpu.nn.nof import NoFConfig as JNoFConfig, init_nof
from moco_flow_tpu.ops import megakernel as jmk
from moco_flow_tpu.train.checkpoint import _flatten as j_flatten
from moco_flow_tpu_torch.nn.nerf import NeRFConfig
from moco_flow_tpu_torch.nn.nof import NoFConfig
from moco_flow_tpu_torch.ops import nerf_rays, nof_chain
from moco_flow_tpu_torch.train.checkpoint import _flatten, params_from_jax

NERF = dict(depth=4, width=64, in_channels_xyz=27, skips=(2,),
            extra_feat_type="ind", extra_feat_dim=5)
NOF = dict(depth=4, width=32, in_channels_xyz=21, skips=(2,),
           extra_feat_dim=21, use_quat=True)
N_RAYS, N_SAMPLES = 7, 12
FP32_TOL = 1e-5
BF16_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    k = jax.random.split(jax.random.key(3), 3)
    params = {"coarse_NeRF": init_nerf(k[0], JNeRFConfig(**NERF)),
              "bw_NoF": init_nof(k[1], JNoFConfig(**NOF)),
              "fw_NoF": init_nof(k[2], JNoFConfig(**NOF))}
    rng = np.random.default_rng(0)
    n, s = N_RAYS, N_SAMPLES
    xyz_t = rng.uniform(-1.0, 1.0, (3, n, s)).astype(np.float32)
    emb = {"extra": rng.normal(size=(n, 5)).astype(np.float32),
           "ind": rng.normal(size=(n, 21)).astype(np.float32),
           "chained": rng.normal(size=(n, 21)).astype(np.float32)}
    anneal = {"nerf": np.array([1.0, 1.0, 0.6, 0.0], np.float32),
              "nof": np.array([1.0, 0.5, 0.0], np.float32)}
    return params, xyz_t, emb, anneal, rng


def _flat(grads) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in j_flatten(grads).items()}


def _compare(got: dict, want: dict, ref32: dict | None, what: str):
    """Each array within FP32_TOL (fp32) or BF16_TOL (bf16, ``ref32`` = the
    JAX fp32 result) of its own scale; in bf16 the JAX bf16-vs-fp32 gap
    must exceed the bound by 100x somewhere."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    gap = 0.0
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape, (what, k)
        assert np.isfinite(g).all(), (what, k)
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        bound = (FP32_TOL if ref32 is None else BF16_TOL) * scale
        assert err <= bound, f"{what} {k}: max|diff| {err:.3e} > {bound:.3e}"
        if ref32 is not None:
            gap = max(gap, float(np.abs(w - ref32[k]).max()) / scale)
    if ref32 is not None:
        assert gap > 100 * BF16_TOL, f"{what}: bf16 gap only {gap:.3e}"


# ---------------------------------------------------------------------------
# NeRF
# ---------------------------------------------------------------------------

def _nerf_jax(setup, sigma_only, dt, n_freqs, anneal, w_loss):
    params, xyz_t, emb, ann, _ = setup
    cfg = JNeRFConfig(**NERF)
    a = jnp.asarray(ann["nerf"]) if anneal else None

    def loss(p, x, e):
        out = jmk.nerf_fused_rays_t(p, cfg, n_freqs, True, a, x,
                                    None if sigma_only else e, sigma_only,
                                    jnp.bfloat16 if dt == "bf16" else None)
        return jnp.sum(out * w_loss), out

    (_, out), (gp, gx, ge) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        params["coarse_NeRF"], jnp.asarray(xyz_t), jnp.asarray(emb["extra"]))
    res = {"out": np.asarray(out), "xyz": np.asarray(gx)}
    if not sigma_only:
        res["extra"] = np.asarray(ge)
    res.update({f"param/{k}": v for k, v in _flat(gp).items()})
    return res


def _nerf_port(setup, sigma_only, dt, n_freqs, anneal, w_loss):
    params, xyz_t, emb, ann, _ = setup
    p = params_from_jax(params["coarse_NeRF"])
    leaves = _flatten(p, leaf=lambda t: t)
    for t in leaves.values():
        t.requires_grad_(True)
    x = torch.from_numpy(xyz_t).requires_grad_(True)
    e = torch.from_numpy(emb["extra"]).requires_grad_(True)
    a = torch.from_numpy(ann["nerf"]) if anneal else None
    out = nerf_rays.nerf_fused_rays_t(
        p, NeRFConfig(**NERF), n_freqs, True, a, x,
        None if sigma_only else e, sigma_only,
        torch.bfloat16 if dt == "bf16" else None)
    torch.sum(out * torch.from_numpy(w_loss)).backward()
    res = {"out": out.detach().numpy(), "xyz": x.grad.numpy()}
    if not sigma_only:
        res["extra"] = e.grad.numpy()
    res.update({f"param/{k}": (t.grad if t.grad is not None
                               else torch.zeros_like(t)).numpy()
                for k, t in leaves.items()})
    return res


@pytest.mark.parametrize("case", [
    dict(sigma_only=False, dt="fp32"), dict(sigma_only=False, dt="bf16"),
    dict(sigma_only=True, dt="fp32"), dict(sigma_only=True, dt="bf16"),
    dict(sigma_only=False, dt="fp32", anneal=False),
    dict(sigma_only=False, dt="fp32", n_freqs=0),
], ids=["full-fp32", "full-bf16", "sigma-fp32", "sigma-bf16",
        "no-anneal", "raw-xyz"])
def test_nerf_fused_rays_t_matches_jax(setup, case):
    """Outputs (4, N, S) or (1, N, S) and the gradients of a weighted sum
    w.r.t. every NeRF parameter, xyz and the extra embedding. ``raw-xyz``:
    n_freqs = 0, the reference's init-config quirk (a 1-frequency pass with
    zero sin/cos rows on both sides)."""
    sigma_only, dt = case["sigma_only"], case["dt"]
    n_freqs = case.get("n_freqs", 4)
    anneal = case.get("anneal", True) and n_freqs > 0
    rng = np.random.default_rng(1)
    w_loss = rng.normal(size=(1 if sigma_only else 4, N_RAYS, N_SAMPLES)
                        ).astype(np.float32)
    args = (setup, sigma_only, dt, n_freqs, anneal, w_loss)
    want = _nerf_jax(*args)
    got = _nerf_port(*args)
    assert got["out"].shape == (1 if sigma_only else 4, N_RAYS, N_SAMPLES)
    ref32 = None
    if dt == "bf16":
        ref32 = _nerf_jax(setup, sigma_only, "fp32", n_freqs, anneal, w_loss)
    _compare(got, want, ref32, f"nerf {case}")


# ---------------------------------------------------------------------------
# NoF warp chain
# ---------------------------------------------------------------------------

def _chain_jax(setup, local, glob, dt, n_freqs, w_loss):
    params, xyz_t, emb, ann, _ = setup
    cfg = JNoFConfig(**NOF)
    a = jnp.asarray(ann["nof"]) if n_freqs else None
    nets = {k: params[k] for k in ("bw_NoF", "fw_NoF")}

    def loss(p, x, ei, ec):
        outs = jmk.nof_chain_rays_t(p, cfg, n_freqs, True, a, x, ei, ec,
                                    local, glob,
                                    jnp.bfloat16 if dt == "bf16" else None)
        outs = [o for o in outs if o is not None]
        return sum(jnp.sum(o * w) for o, w in zip(outs, w_loss)), outs

    (_, outs), (gp, gx, gi, gc) = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(
        nets, jnp.asarray(xyz_t), jnp.asarray(emb["ind"]),
        jnp.asarray(emb["chained"]))
    res = {f"out{i}": np.asarray(o) for i, o in enumerate(outs)}
    res.update({"xyz": np.asarray(gx), "ind": np.asarray(gi),
                "chained": np.asarray(gc)})
    res.update({f"param/{k}": v for k, v in _flat(gp).items()})
    return res


def _chain_port(setup, local, glob, dt, n_freqs, w_loss):
    params, xyz_t, emb, ann, _ = setup
    p = params_from_jax({k: params[k] for k in ("bw_NoF", "fw_NoF")})
    leaves = _flatten(p, leaf=lambda t: t)
    for t in leaves.values():
        t.requires_grad_(True)
    x = torch.from_numpy(xyz_t).requires_grad_(True)
    ei = torch.from_numpy(emb["ind"]).requires_grad_(True)
    ec = torch.from_numpy(emb["chained"]).requires_grad_(True)
    a = torch.from_numpy(ann["nof"]) if n_freqs else None
    outs = nof_chain.nof_chain_rays_t(
        p, NoFConfig(**NOF), n_freqs, True, a, x, ei, ec, local, glob,
        torch.bfloat16 if dt == "bf16" else None)
    outs = [o for o in outs if o is not None]
    sum(torch.sum(o * torch.from_numpy(w))
        for o, w in zip(outs, w_loss)).backward()

    def grad(t):
        return (t.grad if t.grad is not None else torch.zeros_like(t)).numpy()

    res = {f"out{i}": o.detach().numpy() for i, o in enumerate(outs)}
    res.update({"xyz": grad(x), "ind": grad(ei), "chained": grad(ec)})
    res.update({f"param/{k}": grad(t) for k, t in leaves.items()})
    return res


@pytest.mark.parametrize("case", [
    dict(local=True, glob=True, dt="fp32"),
    dict(local=True, glob=True, dt="bf16"),
    dict(local=True, glob=False, dt="fp32"),
    dict(local=True, glob=False, dt="bf16"),
    dict(local=False, glob=True, dt="fp32"),
    dict(local=False, glob=True, dt="bf16"),
    dict(local=False, glob=False, dt="fp32"),
    dict(local=True, glob=True, dt="fp32", n_freqs=0),
], ids=["local+global-fp32", "local+global-bf16", "local-fp32",
        "local-bf16", "global-fp32", "global-bf16", "bw-only", "raw-xyz"])
def test_nof_chain_rays_t_matches_jax(setup, case):
    """cano / recon / chain_recon and the gradients of a weighted sum of
    them w.r.t. every bw and fw NoF parameter, xyz and both frame
    embeddings."""
    local, glob, dt = case["local"], case["glob"], case["dt"]
    n_freqs = case.get("n_freqs", 3)
    n_out = 1 + int(local) + int(glob)
    rng = np.random.default_rng(2)
    w_loss = [rng.normal(size=(3, N_RAYS, N_SAMPLES)).astype(np.float32)
              for _ in range(n_out)]
    args = (setup, local, glob, dt, n_freqs, w_loss)
    want = _chain_jax(*args)
    got = _chain_port(*args)
    ref32 = None
    if dt == "bf16":
        ref32 = _chain_jax(setup, local, glob, "fp32", n_freqs, w_loss)
    _compare(got, want, ref32, f"chain {case}")


def test_kernel_wrappers_reject_other_devices(setup):
    """A tensor that is neither on the CPU nor on a CUDA card has no kernel
    and no plain version: the wrappers raise instead of falling back."""
    meta = torch.empty((3, 2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        nerf_rays.nerf_fwd(None, None, meta, None, [])
    with pytest.raises(ValueError, match="no kernel for device"):
        nof_chain.chain_bwd(None, None, 2, meta, [], [], [], [])
