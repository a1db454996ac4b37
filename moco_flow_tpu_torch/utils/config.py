"""YAML config system.

Port of ``moco_flow_tpu/utils/config.py``: one YAML per stage, the
experiment layout ``save_dir/exp_name/job_name/{ckpts,log,code,config.yaml}``,
a snapshot of the package's source beside the logs, the config saved beside
a checkpoint read back on resume, dict-style access, and the same schema
warnings for unknown keys.

The port needs no YAML package: :func:`load_yaml` reads the subset of YAML
that the published configs use (block mappings and sequences, flow lists and
mappings, quoted and plain scalars, comments, anchors and aliases) and
resolves every plain scalar as ``yaml.safe_load`` (YAML 1.1) does, so
``1e-4`` is a string and ``0.0001`` a float. Anything outside the subset
(tags, several documents, block scalars, merge keys, multi-line plain
scalars) raises ``ValueError`` with its line. ``config.yaml`` is written as
JSON (:func:`dump_config`), which YAML readers, this one included, read back.
"""

from __future__ import annotations

import json
import math
import os
import os.path as osp
import re
import shutil
import time
import warnings

from ..parallel.multihost import is_main

# ---------------------------------------------------------------------------
# Schema validation: every key the framework consumes, by section; unknown
# keys warn, so a typo or a knob the framework does not have cannot silently
# do nothing. The same keys and messages as the JAX package.
# ---------------------------------------------------------------------------

_EMBEDDING_KEYS = {"type", "in_channels", "N_freqs", "logscale"}
_NERF_KEYS = {"type", "D", "W", "in_channels_xyz", "skips",
              "extra_feat_type", "extra_feat_dim", "encoding", "hash"}
_NOF_KEYS = {"type", "D", "W", "in_channels_xyz", "skips",
             "extra_feat_type", "extra_feat_dim", "use_quat"}
_OPT_KEYS = {"type", "lr", "weight_decay", "momentum", "warmup"}

_SCHEMA = {
    "": {"save_dir", "exp_name", "dataloader", "model", "loss",
         "optimizer", "scheduler", "trainer"},
    "dataloader": {"type", "root_dir", "imgs_dir", "size", "val_size",
                   "aabb", "bkgd", "interval", "cache"},
    "model": {"type", "pretrained_path", "pretrained_nerf", "pretrained_nof",
              "coarse_to_fine", "N_rand", "N_sampled", "chunk", "N_samples",
              "N_importance", "use_disp", "perturb", "noise_std",
              "nerf_activate_type", "compute_dtype", "mlp_impl", "remat",
              "fine_budget", "coarse_probe",
              "share_coarse_warps",
              "occ_res", "occ_threshold", "occ_supersample", "occ_extent",
              "occ_tau", "occ_impl", "occ_tighten", "occ_builder",
              "masked_render",
              "frame_sampling",
              "nof_embedding_xyz", "nof_embedding_ind", "nerf_embedding_xyz",
              "nerf_embedding_dir", "nerf_embedding_ind",
              "fw_NoF", "bw_NoF", "coarse_NeRF", "fine_NeRF"},
    "loss": {"type", "weight", "chain_local", "nof_local_weight",
             "chain_global", "nof_global_weight", "img_loss", "nof_loss",
             "msk_loss"},
    "optimizer": _OPT_KEYS | {"moco", "nof"},
    "scheduler": {"type", "decay_step", "decay_gamma", "lr_decay",
                  "num_epochs", "poly_exp"},
    "trainer": {"num_iters", "coarse2fine_start_iter", "coarse2fine_end_iter",
                "val_every_n_step", "vis_img_every_n_val",
                "vis_mesh_video_every_n_val", "save_every_n_step",
                "log_freq"},
}

_MODEL_SUBBLOCKS = {
    "nof_embedding_xyz": _EMBEDDING_KEYS, "nof_embedding_ind": _EMBEDDING_KEYS,
    "nerf_embedding_xyz": _EMBEDDING_KEYS,
    "nerf_embedding_dir": _EMBEDDING_KEYS,
    "nerf_embedding_ind": _EMBEDDING_KEYS,
    "fw_NoF": _NOF_KEYS, "bw_NoF": _NOF_KEYS,
    "coarse_NeRF": _NERF_KEYS, "fine_NeRF": _NERF_KEYS,
}
_LOSS_SUBBLOCKS = {"img_loss", "nof_loss", "msk_loss"}


def validate_config(cfg: dict) -> list:
    """Return a list of warning strings for unknown / known-ignored keys."""
    msgs = []

    def check(d, known, section):
        for k in d or {}:
            if k not in known:
                msgs.append(f"unknown config key '{section}{k}' "
                            f"(known: {', '.join(sorted(known))})")

    check(cfg, _SCHEMA[""], "")
    for section in ("dataloader", "model", "loss", "scheduler", "trainer"):
        block = cfg.get(section)
        if isinstance(block, dict):
            check(block, _SCHEMA[section], section + ".")
    model = cfg.get("model") or {}
    for name, keys in _MODEL_SUBBLOCKS.items():
        sub = model.get(name)
        if isinstance(sub, dict):
            check(sub, keys, f"model.{name}.")
    loss = cfg.get("loss") or {}
    for name in _LOSS_SUBBLOCKS:
        sub = loss.get(name)
        if isinstance(sub, dict):
            check(sub, {"type", "weight"}, f"loss.{name}.")
    opt = cfg.get("optimizer")
    if isinstance(opt, dict):
        check(opt, _SCHEMA["optimizer"], "optimizer.")
        for name in ("moco", "nof"):
            sub = opt.get(name)
            if isinstance(sub, dict):
                check(sub, _OPT_KEYS, f"optimizer.{name}.")
    dl = cfg.get("dataloader") or {}
    if "cache" in dl:
        msgs.append(
            "dataloader.cache is accepted for reference compatibility but "
            "has no effect: images/tables are always HBM-resident here "
            "(a strict superset of the reference's RAM cache)")
    return msgs


# ---------------------------------------------------------------------------
# The YAML subset
# ---------------------------------------------------------------------------

# plain-scalar resolution of YAML 1.1 as PyYAML's resolver has it
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, conv):
    value = 0
    for part in text.split(":"):
        value = value * 60 + conv(part)
    return value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    if t[0] in "+-":
        t = t[1:]
    if t == "0":
        return 0
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if t[0] == "0":
        return sign * int(t, 8)
    if ":" in t:
        return sign * _sexagesimal(t, int)
    return sign * int(t)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t[0] == "-" else 1.0
    if t[0] in "+-":
        t = t[1:]
    if t == ".inf":
        return sign * math.inf
    if t == ".nan":
        return math.nan
    if ":" in t:
        return sign * _sexagesimal(t, float)
    return sign * float(t)


class _Reader:
    """Line-based recursive descent over the comment-stripped lines."""

    def __init__(self, text: str, name: str):
        self.name = name
        self.lines = []        # (line number, indent, content)
        for n, raw in enumerate(text.splitlines(), 1):
            body = self._strip_comment(raw).rstrip()
            if not body.strip():
                continue
            lead = body[:len(body) - len(body.lstrip(" \t"))]
            if "\t" in lead:
                self.fail(n, "a tab in the indentation")
            content = body.strip()
            if n == 1 and content.startswith("%"):
                self.fail(n, "a directive")
            if content in ("---", "...") or content.startswith("--- ") or \
                    content.startswith("... "):
                self.fail(n, "a document marker (one document only)")
            self.lines.append((n, len(lead), content))
        self.anchors = {}

    def fail(self, line: int, what: str):
        raise ValueError(f"{self.name}:{line}: {what} is outside the YAML "
                         "subset that load_yaml reads")

    @staticmethod
    def _strip_comment(raw: str) -> str:
        """The line without its comment (a '#' after a blank, outside
        quotes)."""
        quote = None
        i = 0
        while i < len(raw):
            c = raw[i]
            if quote:
                if c == "\\" and quote == '"':
                    i += 2
                    continue
                if c == quote:
                    if quote == "'" and raw[i + 1:i + 2] == "'":
                        i += 2
                        continue
                    quote = None
            elif c in "'\"" and (i == 0 or raw[i - 1] in " \t[{,:-"):
                quote = c
            elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
                return raw[:i]
            i += 1
        return raw

    # -- scalars --------------------------------------------------------

    def plain(self, text: str, line: int):
        if text in _NULL:
            return None
        if text in _BOOL:
            return _BOOL[text]
        if _INT.match(text):
            return _int(text)
        if _FLOAT.match(text):
            return _float(text)
        if _TIMESTAMP.match(text):
            self.fail(line, f"the timestamp {text!r}")
        if text == "<<":
            self.fail(line, "a merge key")
        if text == "=":
            self.fail(line, "the value key '='")
        if text[0] in "!|>%@`":
            self.fail(line, f"the indicator {text[0]!r}")
        if text[0] == "?" and text[1:2] in ("", " "):
            self.fail(line, "a complex key")
        return text

    def quoted(self, text: str, pos: int, line: int):
        """The quoted scalar at ``text[pos]``; returns (value, end)."""
        q = text[pos]
        out = []
        i = pos + 1
        while i < len(text):
            c = text[i]
            if q == "'":
                if c == "'":
                    if text[i + 1:i + 2] == "'":
                        out.append("'")
                        i += 2
                        continue
                    return "".join(out), i + 1
                out.append(c)
                i += 1
                continue
            if c == '"':
                return "".join(out), i + 1
            if c == "\\":
                e = text[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                elif e in _HEX_ESCAPES:
                    k = _HEX_ESCAPES[e]
                    out.append(chr(int(text[i + 2:i + 2 + k], 16)))
                    i += 2 + k
                else:
                    self.fail(line, f"the escape \\{e}")
                continue
            out.append(c)
            i += 1
        self.fail(line, "a quoted scalar over several lines")

    # -- flow collections -----------------------------------------------

    def flow(self, text: str, pos: int, line: int):
        """The flow node at ``text[pos]``; returns (value, end)."""
        while text[pos:pos + 1] == " ":
            pos += 1
        c = text[pos:pos + 1]
        if c in ("[", "{"):
            close = "]" if c == "[" else "}"
            out = [] if c == "[" else {}
            pos += 1
            while True:
                while text[pos:pos + 1] == " ":
                    pos += 1
                if pos >= len(text):
                    self.fail(line, "an unclosed flow collection")
                if text[pos] == close:
                    return out, pos + 1
                if c == "[":
                    v, pos = self.flow(text, pos, line)
                    out.append(v)
                else:
                    k, pos = self.flow(text, pos, line)
                    while text[pos:pos + 1] == " ":
                        pos += 1
                    if text[pos:pos + 1] != ":":
                        self.fail(line, "a flow mapping entry without ':'")
                    v, pos = self.flow(text, pos + 1, line)
                    out[k] = v
                while text[pos:pos + 1] == " ":
                    pos += 1
                if text[pos:pos + 1] == ",":
                    pos += 1
                elif text[pos:pos + 1] != close:
                    self.fail(line, "a flow collection entry without ','")
        if c in ("'", '"'):
            return self.quoted(text, pos, line)
        if c == "*":
            m = re.match(r"\*([^\s,\[\]{}]+)", text[pos:])
            return self.alias(m.group(1), line), pos + m.end()
        if c == "&":
            m = re.match(r"&([^\s,\[\]{}]+) *", text[pos:])
            v, end = self.flow(text, pos + m.end(), line)
            self.anchors[m.group(1)] = v
            return v, end
        end = pos
        while end < len(text) and text[end] not in ",[]{}" and not (
                text[end] == ":" and text[end + 1:end + 2] in
                (" ", ",", "]", "}", "")):
            end += 1
        return self.plain(text[pos:end].strip(), line), end

    def alias(self, name: str, line: int):
        if name not in self.anchors:
            self.fail(line, f"the undefined alias *{name}")
        return self.anchors[name]

    # -- block nodes ----------------------------------------------------

    @staticmethod
    def _key_split(content: str):
        """(key text, rest) of ``key: rest`` outside quotes and flows, or
        None when the line is not a mapping entry."""
        quote, depth, i = None, 0, 0
        while i < len(content):
            c = content[i]
            if quote:
                if c == quote:
                    if quote == "'" and content[i + 1:i + 2] == "'":
                        i += 2
                        continue
                    quote = None
                elif c == "\\" and quote == '"':
                    i += 1
            elif c in "'\"" and i == 0:
                quote = c
            elif c in "[{":
                depth += 1
            elif c in "]}":
                depth -= 1
            elif c == ":" and depth == 0 and content[i + 1:i + 2] in (" ",
                                                                      ""):
                return content[:i].rstrip(), content[i + 1:].strip()
            i += 1
        return None

    def _gather_flow(self, i: int, text: str):
        """A flow collection may span lines: join them until it closes."""
        def balance(s):
            quote, depth, k = None, 0, 0
            while k < len(s):
                c = s[k]
                if quote:
                    if c == "\\" and quote == '"':
                        k += 1
                    elif c == quote:
                        quote = None
                elif c in "'\"":
                    quote = c
                elif c in "[{":
                    depth += 1
                elif c in "]}":
                    depth -= 1
                k += 1
            return depth
        while balance(text) > 0:
            i += 1
            if i >= len(self.lines):
                self.fail(self.lines[i - 1][0], "an unclosed flow collection")
            text = text + " " + self.lines[i][2]
        return text, i + 1

    def value(self, i: int, rest: str, indent: int, line: int,
              in_mapping: bool = False):
        """The value of an entry whose text after ``key:`` / ``-`` is
        ``rest``, at ``indent``; returns (value, next line index). A
        mapping's value may be a sequence at the key's own indent."""
        anchor = None
        if rest.startswith("&"):
            m = re.match(r"&(\S+)\s*", rest)
            anchor, rest = m.group(1), rest[m.end():]
        if rest.startswith("!"):
            self.fail(line, "a tag")
        if rest in ("|", ">") or rest[:1] in ("|", ">"):
            self.fail(line, "a block scalar")
        if not rest:
            nxt = i + 1
            if nxt < len(self.lines) and (
                    self.lines[nxt][1] > indent or
                    (in_mapping and self.lines[nxt][1] == indent and
                     self._is_item(self.lines[nxt][2]))):
                v, nxt = self.block(nxt, self.lines[nxt][1])
            else:
                v = None
        elif rest[0] in "[{":
            text, nxt = self._gather_flow(i, rest)
            v, end = self.flow(text, 0, line)
            if text[end:].strip():
                self.fail(line, "text after a flow collection")
        elif rest[0] == "*":
            v, nxt = self.alias(rest[1:].strip(), line), i + 1
        elif rest[0] in "'\"":
            v, end = self.quoted(rest, 0, line)
            if rest[end:].strip():
                self.fail(line, "text after a quoted scalar")
            nxt = i + 1
        else:
            if self._key_split(rest) is not None:
                self.fail(line, "a mapping value on a mapping entry's line")
            v, nxt = self.plain(rest, line), i + 1
        if rest and nxt < len(self.lines) and self.lines[nxt][1] > indent:
            self.fail(self.lines[nxt][0], "a multi-line plain scalar or "
                      "an unexpected indentation")
        if anchor is not None:
            self.anchors[anchor] = v
        return v, nxt

    @staticmethod
    def _is_item(content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def block(self, i: int, indent: int):
        line, _, content = self.lines[i]
        if self._is_item(content):
            return self.sequence(i, indent)
        if self._key_split(content) is None:
            # a lone node: a flow collection, an alias or a scalar
            return self.value(i, content, indent, line)
        return self.mapping(i, indent)

    def mapping(self, i: int, indent: int):
        out = {}
        while i < len(self.lines):
            line, ind, content = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                self.fail(line, "an unexpected indentation")
            if self._is_item(content):
                break
            split = self._key_split(content)
            if split is None:
                self.fail(line, "a line that is not a mapping entry")
            ktext, rest = split
            if ktext.startswith("? ") or ktext == "?":
                self.fail(line, "a complex key")
            if ktext[:1] in ("'", '"'):
                key, end = self.quoted(ktext, 0, line)
                if ktext[end:].strip():
                    self.fail(line, "text after a quoted key")
            elif ktext[:1] in "[{&*!":
                self.fail(line, f"a key starting with {ktext[0]!r}")
            else:
                if ktext == "<<":
                    self.fail(line, "a merge key")
                key = self.plain(ktext, line)
            out[key], i = self.value(i, rest, indent, line, in_mapping=True)
        return out, i

    def sequence(self, i: int, indent: int):
        out = []
        while i < len(self.lines):
            line, ind, content = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                self.fail(line, "an unexpected indentation")
            if not self._is_item(content):
                break
            rest = content[1:].lstrip(" ")
            if rest and (self._is_item(rest) or
                         self._key_split(rest) is not None):
                # a compact node on the item's line: re-read the line with
                # the item's text at its own column
                col = indent + len(content) - len(rest)
                self.lines[i] = (line, col, rest)
                v, i = self.block(i, col)
            else:
                v, i = self.value(i, rest, indent, line)
            out.append(v)
        return out, i

    def document(self):
        if not self.lines:
            return None
        v, i = self.block(0, self.lines[0][1])
        if i < len(self.lines):
            self.fail(self.lines[i][0], "text after the document")
        return v


def load_yaml_text(text: str, name: str = "<string>"):
    """Parse YAML ``text`` of the supported subset (module docstring)."""
    return _Reader(text, name).document()


def load_yaml(path: str):
    """Read a YAML file of the supported subset; ``ValueError`` names the
    line of anything outside it."""
    with open(path) as f:
        return load_yaml_text(f.read(), path)


def _yaml_float(x: float) -> str:
    """A float as text that YAML 1.1 resolves as a float too: JSON's
    ``1e-05`` is a string there, ``1.0e-05`` a float."""
    if math.isnan(x):
        return ".nan"
    if math.isinf(x):
        return ".inf" if x > 0 else "-.inf"
    text = repr(x)
    mant, e, exp = text.partition("e")
    if e and "." not in mant:
        text = f"{mant}.0e{exp}"
    return text


def _emit(obj, pad: str) -> str:
    inner = pad + "  "
    if isinstance(obj, dict):
        if not obj:
            return "{}"
        return "{\n" + ",\n".join(
            f"{inner}{json.dumps(str(k))}: {_emit(v, inner)}"
            for k, v in obj.items()) + f"\n{pad}}}"
    if isinstance(obj, (list, tuple)):
        items = [_emit(v, inner) for v in obj]
        if all(not isinstance(v, (dict, list, tuple)) for v in obj):
            return "[" + ", ".join(items) + "]"
        return "[\n" + ",\n".join(inner + v for v in items) + f"\n{pad}]"
    if isinstance(obj, float):
        return _yaml_float(obj)
    if obj is None or isinstance(obj, (bool, int, str)):
        return json.dumps(obj)
    raise TypeError(f"cannot write {type(obj).__name__} into config.yaml")


def dump_config_text(cfg: dict) -> str:
    """``cfg`` as JSON, which is YAML: every value reads back equal through
    :func:`load_yaml_text` and ``yaml.safe_load``."""
    return _emit(cfg, "") + "\n"


def dump_config(cfg: dict, path: str):
    with open(path, "w") as f:
        f.write(dump_config_text(cfg))


class Config:
    """Parsed config with the experiment-directory services of JAX's
    ``Config``: with ``mode == "train"`` the constructor makes
    ``exp_dir/{ckpts,log}``, writes ``config.yaml`` and snapshots the
    package's source under ``exp_dir/code/moco_flow_tpu_torch``, on rank 0
    of a data-parallel run only (JAX's writes on every process)."""

    def __init__(self, cfg: dict, mode: str = "train",
                 resume: str | None = None, job_name: str | None = None,
                 seed: int | None = None):
        self._cfg = cfg
        self.mode = mode
        self.resume = resume
        self.seed = seed
        for msg in validate_config(cfg):
            warnings.warn(msg, stacklevel=2)
        self.save_dir = cfg.get("save_dir", "./log")
        self.exp_name = cfg.get("exp_name", "exp")
        self.job_name = job_name or time.strftime("%b%d_%H%M%S")
        self.exp_dir = osp.join(self.save_dir, self.exp_name, self.job_name)
        self.ckpts_dir = osp.join(self.exp_dir, "ckpts")
        self.log_dir = osp.join(self.exp_dir, "log")
        if mode == "train" and is_main():
            os.makedirs(self.ckpts_dir, exist_ok=True)
            os.makedirs(self.log_dir, exist_ok=True)
            dump_config(cfg, osp.join(self.exp_dir, "config.yaml"))
            self._snapshot_code()

    def _snapshot_code(self):
        """Copy the package's source beside the logs, once a job."""
        pkg = osp.dirname(osp.dirname(osp.abspath(__file__)))
        dst = osp.join(self.exp_dir, "code", "moco_flow_tpu_torch")
        if not osp.exists(dst):
            shutil.copytree(pkg, dst,
                            ignore=shutil.ignore_patterns("__pycache__"))

    @classmethod
    def from_file(cls, path: str, **kwargs) -> "Config":
        return cls(load_yaml(path), **kwargs)

    @classmethod
    def from_args(cls, args, mode: str | None = None) -> "Config":
        """argparse namespace -> Config; with ``--resume``, the config saved
        beside the checkpoint's run wins."""
        cfg_path = args.config
        resume = getattr(args, "resume", None)
        if resume:
            saved = osp.join(osp.dirname(osp.dirname(resume)), "config.yaml")
            if osp.exists(saved):
                cfg_path = saved
        return cls.from_file(
            cfg_path,
            mode=mode or getattr(args, "mode", "train"),
            resume=resume,
            job_name=getattr(args, "job_name", None),
            seed=int(args.seed) if getattr(args, "seed", None) is not None
            else None)

    def __getitem__(self, key):
        return self._cfg[key]

    def __contains__(self, key):
        return key in self._cfg

    def get(self, key, default=None):
        return self._cfg.get(key, default)

    @property
    def raw(self) -> dict:
        return self._cfg
