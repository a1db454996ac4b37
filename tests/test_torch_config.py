"""The port's config system (``moco_flow_tpu_torch/utils/config.py``)
against PyYAML and the JAX package's ``utils/config.py``.

``load_yaml`` reads the three published YAMLs exactly as ``yaml.safe_load``
does (anchors and aliases included), resolves every plain scalar form as
YAML 1.1 does (``1e-4`` is a string, ``0.0001`` a float) and raises,
naming the line, on what lies outside its subset. ``validate_config`` gives
JAX's warning strings. ``Config`` writes JAX's layout, and the
``config.yaml`` it writes (JSON) reads back through ``yaml.safe_load``,
``load_yaml`` and JAX's ``Config.from_args`` on resume.
"""

import argparse
import glob
import math
import os
import os.path as osp
import warnings

import pytest
import yaml

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.utils.config import Config as JaxConfig
from moco_flow_tpu.utils.config import validate_config as jax_validate
from moco_flow_tpu_torch.utils.config import (Config, dump_config_text,
                                              load_yaml, load_yaml_text,
                                              validate_config)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
YAMLS = sorted(glob.glob(osp.join(ROOT, "configs", "**", "*.yaml"),
                         recursive=True))
NAMES = [osp.basename(p) for p in YAMLS]


def _same(a, b) -> bool:
    """Equal, with type (1 != 1.0 != True here) and NaN == NaN."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


def test_the_published_yamls_are_three():
    assert sorted(NAMES) == ["c2f.yaml", "init_nerf.yaml", "init_nof.yaml"]


@pytest.mark.parametrize("path", YAMLS, ids=NAMES)
def test_load_yaml_equals_pyyaml(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = load_yaml(path)
    assert _same(got, want)


def test_anchors_alias_one_object_as_pyyaml():
    """``bw_NoF: *nof`` is the same dict as ``fw_NoF: &nof`` (PyYAML's
    aliases are one object too)."""
    got = load_yaml(osp.join(ROOT, "configs", "people_snapshot",
                             "male-3-casual", "c2f.yaml"))
    assert got["model"]["bw_NoF"] is got["model"]["fw_NoF"]
    assert got["model"]["fine_NeRF"] is got["model"]["coarse_NeRF"]


@pytest.mark.parametrize("text", [
    "0.0001", "1e-4", "1.0e-4", "1.0e+4", "1.5e3", "'rand'", '"rand"',
    "null", "~", "Null", "[1050000]", "[1.2, 1.2, 1.4]", "true", "False",
    "yes", "off", "On", "0x1F", "017", "0b101", "1_000", "+12", "-0", "0.",
    ".5", "-1", "190:20:30", "1:20.5", ".inf", "-.Inf", ".NaN", "abc def",
    "'it''s'", '"a\\tb \\u00e9"', "./log/people_snapshot/male-3-casual",
    "{type: 'Embedding', in_channels: 3, N_freqs: 5, logscale: true}",
    "{a: [x, 'y', {c: null}], b: }", "[]", "{}", "'x # not a comment'",
    "value # a comment"])
def test_scalar_forms_resolve_as_pyyaml(text):
    src = f"k: {text}\n"
    assert _same(load_yaml_text(src), yaml.safe_load(src)), text


def test_block_forms_as_pyyaml():
    src = ("a:\n- 1\n- 2\nb:\n  - x: 1\n    y: [2]\n  - - 3\n    - 4\n"
           "c: &c\n  d: {e: 1}\nf: *c\n'g h': 'i'\n\n# closing comment\n")
    assert _same(load_yaml_text(src), yaml.safe_load(src))


@pytest.mark.parametrize("name,text,line", [
    ("tag", "a: 1\nk: !!str 3\n", 2),
    ("documents", "a: 1\n---\nb: 2\n", 2),
    ("literal block scalar", "k: |\n  text\n", 1),
    ("folded block scalar", "k: >\n  text\n", 1),
    ("merge key", "a: &x {b: 1}\nc:\n  <<: *x\n", 3),
    ("multi-line plain scalar", "k: abc\n  def\n", 2),
    ("timestamp", "k: 2001-12-14\n", 1),
    ("undefined alias", "k: *nope\n", 1),
    ("unclosed flow", "k: [1, 2\n", 1),
    ("complex key", "? a\n: b\n", 1),
    ("directive", "%YAML 1.1\n---\na: 1\n", 1),
    ("tab indentation", "a:\n\tb: 1\n", 2),
])
def test_outside_the_subset_raises_with_its_line(name, text, line):
    with pytest.raises(ValueError, match=f"^f.yaml:{line}: "):
        load_yaml_text(text, "f.yaml")


@pytest.mark.parametrize("value", [1e-5, 0.0001, 1e20, 3.0, -2.5e-300,
                                   float("inf"), float("nan"), 7, True,
                                   None, "1e-4", "null", "a\"b\\c\u00e9"])
def test_dump_round_trips_through_both_readers(value):
    cfg = {"x": value, "l": [1, value], "d": {"e": [{"f": value}]}}
    text = dump_config_text(cfg)
    assert _same(yaml.safe_load(text), cfg)
    assert _same(load_yaml_text(text), cfg)


def _unknown_key_dicts():
    return [
        {"save_dir": "s", "typo_top": 1},
        {"model": {"N_importence": 64, "fine_NeRF": {"W": 1, "widht": 2}},
         "loss": {"img_loss": {"type": "MSE", "wieght": 1}}},
        {"optimizer": {"moco": {"type": "adam", "betas": [1, 2]},
                       "bogus": 3}, "trainer": {"num_iter": 5},
         "dataloader": {"cache": True, "sise": 4},
         "scheduler": {"gamma": 0.5}},
    ]


@pytest.mark.parametrize("case", list(range(3 + len(YAMLS))))
def test_validate_config_strings_equal_jax(case):
    cfgs = [load_yaml(p) for p in YAMLS] + _unknown_key_dicts()
    cfg = cfgs[case]
    got = validate_config(cfg)
    assert got == jax_validate(cfg)
    if case >= len(YAMLS):
        assert got


def test_config_layout_and_resume(tmp_path):
    cfg = load_yaml(YAMLS[0])
    cfg["save_dir"] = str(tmp_path / "log")
    cfg["model"]["lr_like"] = 1e-5      # an unknown key warns, as in JAX
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c = Config(cfg, mode="train", job_name="job", seed=3)
    assert any("model.lr_like" in str(w.message) for w in caught)
    exp = osp.join(str(tmp_path / "log"), cfg["exp_name"], "job")
    assert (c.exp_dir, c.ckpts_dir, c.log_dir) == (
        exp, osp.join(exp, "ckpts"), osp.join(exp, "log"))
    for d in (c.ckpts_dir, c.log_dir):
        assert osp.isdir(d)
    snap = osp.join(exp, "code", "moco_flow_tpu_torch")
    assert osp.exists(osp.join(snap, "utils", "config.py"))
    assert not glob.glob(osp.join(snap, "**", "__pycache__"),
                         recursive=True)
    saved = osp.join(exp, "config.yaml")
    with open(saved) as f:
        assert _same(yaml.safe_load(f), cfg)
    assert _same(load_yaml(saved), cfg)
    assert c["model"] is cfg["model"] and "trainer" in c and c.seed == 3
    # a resumed run reads the config saved beside the checkpoint: JAX's
    # Config.from_args and the port's
    other = tmp_path / "other.yaml"
    other.write_text("save_dir: elsewhere\n")
    args = argparse.Namespace(config=str(other),
                              resume=osp.join(c.ckpts_dir, "final.npz"),
                              job_name="job2", seed="5", mode="test")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jc = JaxConfig.from_args(args, mode="test")
        pc = Config.from_args(args, mode="test")
    assert _same(jc.raw, cfg) and _same(pc.raw, cfg)
    assert pc.resume == args.resume and pc.seed == 5
    assert (pc.exp_dir, jc.exp_dir) == (osp.join(cfg["save_dir"],
                                                 cfg["exp_name"], "job2"),) * 2
    assert not osp.exists(pc.exp_dir)       # test mode makes no directories
    args.resume = None
    assert Config.from_args(args, mode="test").raw == {"save_dir":
                                                       "elsewhere"}
    assert os.listdir(osp.join(str(tmp_path / "log"), cfg["exp_name"])) == [
        "job"]
