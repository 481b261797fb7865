"""Configuration tree (port of mmdti_tpu/configs/config.py) with a YAML
reader and writer of its own.

``Config`` is a dict with attribute access; ``DEFAULT_CONFIG`` holds the
trainer and data defaults of the JAX package.  ``save_yaml`` and
``load_yaml`` keep the ``config.yaml`` artifact contract without PyYAML:
they cover the YAML that ``yaml.safe_dump(cfg, default_flow_style=False,
sort_keys=False)`` writes for a config, that is block mappings, nested
mappings, block lists and the empty ``{}`` and ``[]``, with null, bool,
int, float and string scalars resolved by YAML 1.1's rules (``1e-05``
without a dot is a string; floats are written as PyYAML writes them,
``1.0e-05``).
The writer quotes every string, so each scalar reads back as its own type.
"""

from __future__ import annotations

import copy
import json
import math
import re
from typing import Any, Dict, List, Tuple


class Config(dict):
    """Dict with attribute access, nested-aware."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for src in list(args) + [kwargs]:
            if src is None:
                continue
            for k, v in dict(src).items():
                self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def get(self, key, default=None):
        return super().get(key, default)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, Config) else v for k, v in self.items()}

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def update_from(self, other: Dict[str, Any]) -> "Config":
        for k, v in other.items():
            self[k] = v
        return self


DEFAULT_CONFIG: Dict[str, Any] = {
    # data
    "smiles_col": "SMILES",
    "target_col_prefix": "TARGET",
    "target_normalize": "auto",
    "anomaly_clean": True,
    "smi_strict": False,
    # model
    "model_name": "mm_model",
    # trainer
    "split_method": "5fold_random",
    "split_seed": 42,
    "seed": 42,
    "logger_level": 1,
    "patience": 10,
    "max_epochs": 100,
    "learning_rate": 1e-4,
    "warmup_ratio": 0.03,
    "batch_size": 16,
    "max_norm": 5.0,
    "cuda": True,
    "amp": True,
    "compute_dtype": "bfloat16",
    "pad_mode": "dataset",      # 'dataset' | 'bucket' | 'fixed'
    "pad_multiple": 16,
    "num_workers": 0,
    "prefetch": 2,
    "mesh_shape": None,
    "use_pallas": "auto",        # 'auto' | True | False: the kernel path
}


def default_config() -> Config:
    return Config(copy.deepcopy(DEFAULT_CONFIG))


# ---- writer ----------------------------------------------------------------

def _float_text(v: float) -> str:
    """A float as PyYAML's representer writes it."""
    if math.isnan(v):
        return ".nan"
    if math.isinf(v):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _scalar_text(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if isinstance(v, str):
        if v.isprintable():
            return "'" + v.replace("'", "''") + "'"
        return json.dumps(v)        # a double-quoted YAML scalar with escapes
    if hasattr(v, "item") and getattr(v, "shape", None) == ():   # a numpy scalar
        return _scalar_text(v.item())
    raise TypeError(f"config.yaml cannot hold a {type(v).__name__}: {v!r}")


def _key_text(k) -> str:
    if not isinstance(k, str):
        raise TypeError(f"config keys must be strings, got {k!r}")
    return k if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", k) else _scalar_text(k)


def _emit(value, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for k, v in value.items():
            if isinstance(v, dict) and v:
                out.append(f"{pad}{_key_text(k)}:")
                _emit(v, indent + 2, out)
            elif isinstance(v, (list, tuple)) and v:
                out.append(f"{pad}{_key_text(k)}:")
                _emit(list(v), indent, out)        # PyYAML: items at the key's indent
            else:
                out.append(f"{pad}{_key_text(k)}: {_inline(v)}")
    else:
        for item in value:
            if isinstance(item, dict) and item:
                sub: List[str] = []
                _emit(item, indent + 2, sub)
                out.append(f"{pad}- {sub[0].lstrip()}")
                out.extend(sub[1:])
            elif isinstance(item, (list, tuple)) and item:
                sub = []
                _emit(list(item), indent + 2, sub)
                out.append(f"{pad}- {sub[0].lstrip()}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_inline(item)}")


def _inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar_text(v)


def dump_yaml(data: Dict[str, Any]) -> str:
    out: List[str] = []
    _emit(data, 0, out)
    return "\n".join(out) + "\n" if out else "{}\n"


def save_yaml(cfg: Dict[str, Any], path: str) -> None:
    data = cfg.to_dict() if isinstance(cfg, Config) else dict(cfg)
    with open(path, "w", encoding="utf-8") as f:
        f.write(dump_yaml(data))


# ---- reader ----------------------------------------------------------------

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?")
_BOOL = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}


def _resolve_plain(text: str):
    """A plain scalar by YAML 1.1's implicit resolvers (as PyYAML)."""
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in ("true", "True", "TRUE", "false", "False", "FALSE", "yes", "Yes", "YES",
                "no", "No", "NO", "on", "On", "ON", "off", "Off", "OFF"):
        return _BOOL[text.lower()]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if re.fullmatch(r"[-+]?\.(inf|Inf|INF)", text):
        return float("-inf") if text.startswith("-") else float("inf")
    if re.fullmatch(r"\.(nan|NaN|NAN)", text):
        return float("nan")
    if _FLOAT.fullmatch(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    return text


_ESCAPES = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "0": "\0", "/": "/", " ": " "}


def _parse_scalar(text: str):
    text = text.strip()
    if text.startswith("'"):
        if not text.endswith("'") or len(text) < 2:
            raise ValueError(f"unterminated quoted scalar: {text}")
        return text[1:-1].replace("''", "'")
    if text.startswith('"'):
        if not text.endswith('"') or len(text) < 2:
            raise ValueError(f"unterminated quoted scalar: {text}")
        body, out, i = text[1:-1], [], 0
        while i < len(body):
            c = body[i]
            if c == "\\" and i + 1 < len(body):
                nxt = body[i + 1]
                if nxt in "xuU":
                    n = {"x": 2, "u": 4, "U": 8}[nxt]
                    out.append(chr(int(body[i + 2:i + 2 + n], 16)))
                    i += 2 + n
                    continue
                out.append(_ESCAPES.get(nxt, nxt))
                i += 2
                continue
            out.append(c)
            i += 1
        return "".join(out)
    if text == "{}":
        return {}
    if text == "[]":
        return []
    return _resolve_plain(text)


def _split_key(line: str) -> Tuple[str, str]:
    """'key: value' -> (key, value text); the key may be quoted."""
    line = line.strip()
    if line[:1] in "'\"":
        end = line.index(line[0], 1)
        while line[0] == "'" and line[end + 1:end + 2] == "'":
            end = line.index("'", end + 2)
        key, rest = _parse_scalar(line[:end + 1]), line[end + 1:]
        if not rest.startswith(":"):
            raise ValueError(f"expected ':' after key in {line!r}")
        return key, rest[1:].strip()
    m = re.match(r"([^:#]*?):(\s+|$)", line)
    if not m:
        raise ValueError(f"not a 'key: value' line: {line!r}")
    return m.group(1).strip(), line[m.end():].strip()


_BLANK = -1   # the indent recorded for an empty line


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        stripped = raw.strip()
        if stripped.startswith("#") or stripped in ("---", "..."):
            continue
        out.append((len(raw) - len(raw.lstrip(" ")), raw.rstrip()) if stripped
                   else (_BLANK, ""))
    return out


def _skip_blank(lines, i):
    while i < len(lines) and lines[i][0] == _BLANK:
        i += 1
    return i


def _continuation(lines, i, indent, value):
    """Fold a scalar's continuation lines (PyYAML wraps long scalars at 80
    columns onto lines indented deeper than their key): a line break reads
    as a space, each empty line as a newline, and a double-quoted line
    ending in a backslash joins the next with nothing between."""
    while True:
        j = _skip_blank(lines, i)
        if j < len(lines) and lines[j][0] > indent and not _is_item(lines[j][1]) \
                and not _looks_like_key(lines[j][1]):
            nxt = lines[j][1].strip()
            trailing = len(value) - len(value.rstrip("\\"))
            if value.startswith('"') and trailing % 2:      # an escaped line break
                value = value[:-1] + nxt
            else:
                value += ("\n" * (j - i) if j > i else " ") + nxt
            i = j + 1
        else:
            return value, i


def _is_item(line: str) -> bool:
    s = line.lstrip()
    return s == "-" or s.startswith("- ")


def _looks_like_key(line: str) -> bool:
    s = line.strip()
    if s[:1] in "'\"":
        return False
    return bool(re.match(r"[^:#\s][^:#]*:(\s|$)", s))


def _parse_block(lines, i, indent):
    i = _skip_blank(lines, i)
    if _is_item(lines[i][1]):
        return _parse_list(lines, i, indent)
    return _parse_map(lines, i, indent)


def _parse_map(lines, i, indent):
    out: Dict[str, Any] = {}
    while (i := _skip_blank(lines, i)) < len(lines) and lines[i][0] == indent \
            and not _is_item(lines[i][1]):
        key, rest = _split_key(lines[i][1])
        i = i + 1
        if rest:
            rest, i = _continuation(lines, i, indent, rest)
            out[key] = _parse_scalar(rest)
        elif (i := _skip_blank(lines, i)) < len(lines) and (
                lines[i][0] > indent or (lines[i][0] == indent and _is_item(lines[i][1]))):
            out[key], i = _parse_block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def _parse_list(lines, i, indent):
    out: List[Any] = []
    while (i := _skip_blank(lines, i)) < len(lines) and lines[i][0] == indent \
            and _is_item(lines[i][1]):
        body = lines[i][1].strip()[1:].strip()
        if not body:
            i = _skip_blank(lines, i + 1)
            val = None
            if i < len(lines) and lines[i][0] > indent:
                val, i = _parse_block(lines, i, lines[i][0])
            out.append(val)
            continue
        child = indent + 2
        if _looks_like_key(body) or _is_item(body):
            # an inline first entry of a nested mapping or list
            lines[i] = (child, " " * child + body)
            val, i = _parse_block(lines, i, child)
            out.append(val)
        else:
            i += 1
            body, i = _continuation(lines, i, indent, body)
            out.append(_parse_scalar(body))
    return out, i


def load_yaml_text(text: str) -> Any:
    lines = _lines(text)
    start = _skip_blank(lines, 0)
    if start == len(lines):
        return None
    value, i = _parse_block(lines, start, lines[start][0])
    i = _skip_blank(lines, i)
    if i != len(lines):
        raise ValueError(f"config.yaml: cannot read line {lines[i][1]!r}")
    return value


def load_yaml(path: str) -> Config:
    with open(path, "r", encoding="utf-8") as f:
        data = load_yaml_text(f.read())
    return Config(data or {})
