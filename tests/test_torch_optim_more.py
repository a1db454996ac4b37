"""The port's optimizers and schedules (``moco_flow_tpu_torch/train/optim.py``)
against the JAX package's ``make_optimizer`` / ``make_schedule``.

Each case runs 12 updates of the JAX chain and of the port's optimizer on
the same parameters and gradients (a zero gradient at update 3, so a
momentum or a moment carries the step alone), and holds the parameters
after every update within 1e-6 of each leaf's largest magnitude (relative;
both sides round the same float32 formulas, the schedules' ``cos`` / ``**``
may differ by an ulp). Then the state in ``opt_named`` form against JAX's
keystr paths (same keys, values within 1e-6 relative), and both ways of a
resume: a port optimizer restored from JAX's state after 6 updates, and JAX
restored from the port's, each continue 6 updates as the other does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.train import optim as joptim
from moco_flow_tpu.train.checkpoint import _flatten as j_flatten
from moco_flow_tpu_torch.train import optim
from moco_flow_tpu_torch.train.checkpoint import _flatten

RTOL = 1e-6
STEPS, MID = 12, 6

OPTIMIZERS = {
    "sgd": {"type": "sgd", "lr": 1e-2},
    "sgd-momentum": {"type": "sgd", "lr": 1e-2, "momentum": 0.9},
    "sgd-momentum-wd": {"type": "sgd", "lr": 1e-2, "momentum": 0.9,
                        "weight_decay": 1e-2},
    "adam-wd": {"type": "adam", "lr": 1e-2, "weight_decay": 1e-2},
    "adamw-warmup": {"type": "adamw", "lr": 1e-2, "weight_decay": 1e-2,
                     "warmup": 4},
    "adamw": {"type": "adamw", "lr": 1e-2},
    "ranger": {"type": "ranger", "lr": 1e-2},
    "ranger-wd": {"type": "ranger", "lr": 1e-2, "weight_decay": 1e-2},
    "radam-wd": {"type": "radam", "lr": 1e-2, "weight_decay": 1e-2},
}
SCHEDULES = {
    "none": None,
    "steplr": {"type": "steplr", "decay_step": [8], "decay_gamma": 0.5},
    "explr": {"type": "explr", "lr_decay": 0.9},
    "cosine": {"type": "cosine", "num_epochs": 10},
    "poly": {"type": "poly", "num_epochs": 10, "poly_exp": 2},
}
# every optimizer, every schedule, with and without weight decay
CASES = [("sgd", "none"), ("sgd-momentum", "explr"),
         ("sgd-momentum-wd", "cosine"), ("adam-wd", "poly"),
         ("adam-wd", "steplr"), ("adamw-warmup", "cosine"),
         ("adamw-warmup", "none"), ("adamw", "explr"), ("ranger", "none"),
         ("ranger", "poly"), ("ranger-wd", "explr"),
         ("radam-wd", "cosine")]


def _tree(rng):
    return {"a": {"w": rng.normal(size=(5, 4)).astype(np.float32),
                  "b": rng.normal(size=(4,)).astype(np.float32)},
            "c": [rng.normal(size=(3,)).astype(np.float32)]}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: {err:.3e} > {RTOL * scale:.3e}"


def _named(state) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}


def _unnamed(like, named: dict):
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(named[jax.tree_util.keystr(p)]).astype(v.dtype)
        for p, v in paths])


def _port_step(opt, names, tensors, g):
    gd = _flatten(g)
    for name, t in zip(names, tensors):
        t.grad = torch.from_numpy(gd[name].copy())
    opt.step()


@pytest.mark.parametrize("okey,skey", CASES)
def test_optimizer_matches_optax(okey, skey):
    ocfg, scfg = OPTIMIZERS[okey], SCHEDULES[skey]
    rng = np.random.default_rng(3)
    params0 = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    grads[3] = jax.tree.map(np.zeros_like, grads[3])
    jopt = joptim.make_optimizer(ocfg, scfg)
    jp = jax.tree.map(jnp.asarray, params0)
    jstate = jopt.init(jp)
    names = list(_flatten(params0))
    tp = [torch.from_numpy(v.copy()) for v in _flatten(params0).values()]
    topt = optim.make_optimizer(tp, ocfg, scfg, names=names)
    mid = None
    for i, g in enumerate(grads):
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        _port_step(topt, names, tp, g)
        got = dict(zip(names, tp))
        for k, want in j_flatten(jp).items():
            _close(got[k].numpy(), want, f"update {i} {k}")
        if i + 1 == MID:
            mid = (_named(jstate), jp, topt.state_named("['moco']"),
                   [t.clone() for t in tp])
    # the state in opt_named form
    want = _named(jstate)
    got = topt.state_named("")
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, k)
    # JAX's state after MID updates -> a fresh port optimizer
    jnamed, jp_mid, tnamed, tp_mid = mid
    p6 = [t.clone() for t in tp_mid]
    resumed = optim.make_optimizer(p6, ocfg, scfg, names=names)
    resumed.load_named(jnamed, "")
    if any(k.endswith("count") for k in jnamed):   # unscheduled sgd: none
        assert resumed.count == MID
    for g in grads[MID:]:
        _port_step(resumed, names, p6, g)
    for got_t, want_t in zip(p6, tp):
        _close(got_t.numpy(), want_t.numpy(), "port resumed from JAX")
    # the port's state after MID updates -> JAX
    jstate2 = _unnamed(jopt.init(jp_mid),
                       {k[len("['moco']"):]: v for k, v in tnamed.items()})
    jp2 = jp_mid
    for g in grads[MID:]:
        upd, jstate2 = jopt.update(jax.tree.map(jnp.asarray, g), jstate2,
                                   jp2)
        jp2 = optax.apply_updates(jp2, upd)
    for k, want_t in j_flatten(jp).items():
        _close(np.asarray(j_flatten(jp2)[k]), want_t, f"JAX resumed {k}")


@pytest.mark.parametrize("skey", ["steplr", "explr", "cosine", "poly"])
def test_schedule_matches_jax(skey):
    """The port's schedule against JAX's at counts 0-14 (past
    ``num_epochs``), 1e-6 relative."""
    cfg = SCHEDULES[skey]
    js = joptim.make_schedule(cfg, 3e-3)
    ts = optim.make_schedule(cfg, 3e-3)
    for c in range(15):
        _close(ts(c), np.asarray(js(jnp.int32(c))), f"count {c}")


def test_unknown_optimizer_and_schedule_raise():
    t = [torch.zeros(2)]
    with pytest.raises(ValueError, match="lamb"):
        optim.make_optimizer(t, {"type": "lamb", "lr": 1e-3})
    with pytest.raises(ValueError, match="onecycle"):
        optim.make_schedule({"type": "onecycle"}, 1e-3)
