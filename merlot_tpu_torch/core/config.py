"""Config system: YAML -> typed sections (counterpart of
merlot_tpu/core/config.py).

``NeatConfig`` keeps the JAX package's surface: four mandatory sections
``data/model/optimizer/device`` plus optional ``downstream/validate/misc``,
glob expansion of ``train_file``/``val_file``/``test_file`` and one
positional YAML argument on the command line.

The YAML is read by ``load_yaml``, this module's own reader, never by
pyyaml. It reads the subset the repo's configs use and refuses everything
else with a ``YamlError``:
  * block mappings (indented by spaces);
  * ``#`` comments, on their own lines and after values;
  * plain, single-quoted and double-quoted scalars on one line;
  * flow sequences ``[...]`` and flow mappings ``{...}``, which may span
    lines, nest and end with a trailing comma.
Scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1): ``true``,
``on``, ``yes`` are booleans, ``~``/``null``/empty are None, ``0x1f`` and
``0o``-style octals are ints, and a float needs a dot, so ``1e-4`` is the
string "1e-4" while ``1.0e-4`` is a float.
"""

from __future__ import annotations

import argparse
import glob as _glob
import re
from copy import deepcopy
from typing import Any, Dict, List, Optional, Sequence, Tuple

MANDATORY_SECTIONS = ("data", "model", "optimizer", "device")
OPTIONAL_SECTIONS = ("downstream", "validate", "misc")


# ----------------------------------------------------------------------
# the YAML reader
# ----------------------------------------------------------------------
class YamlError(ValueError):
    """The text is not YAML, or uses YAML outside the supported subset."""


# yaml.safe_load's implicit resolvers (YAML 1.1), in the order it tries them
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                         (?:[Tt]|[ \t]+)[0-9][0-9]?
                         :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                         (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}

_FLOW_END = ",[]{}"
# characters that cannot start a plain scalar in this subset (anchors,
# aliases, tags, block scalars, directives, reserved indicators)
_NOT_PLAIN = "&*!|>%@`"


def _sexagesimal(parts: List[float]) -> float:
    value, base = 0, 1
    for digit in reversed(parts):
        value += digit * base
        base *= 60
    return value


def resolve_plain(text: str) -> Any:
    """The value ``yaml.safe_load`` gives an unquoted scalar."""
    if _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * float("inf")
        if value == ".nan":
            return float("nan")
        if ":" in value:
            return sign * _sexagesimal([float(p) for p in value.split(":")])
        return sign * float(value)
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal([int(p) for p in value.split(":")])
        return sign * int(value)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text) or text in ("<<", "="):
        raise YamlError(f"the scalar {text!r} resolves to a timestamp, merge key or "
                        f"value key: outside the supported YAML subset")
    return text


class _Reader:
    """Recursive descent over the text, one character position at a time."""

    def __init__(self, text: str, name: str):
        self.text = text.replace("\r\n", "\n")
        self.name = name
        self.pos = 0

    # -- position helpers ---------------------------------------------
    def error(self, msg: str) -> YamlError:
        line = self.text.count("\n", 0, self.pos) + 1
        col = self.pos - (self.text.rfind("\n", 0, self.pos) + 1) + 1
        return YamlError(f"{self.name}:{line}:{col}: {msg}")

    def peek(self, k: int = 0) -> str:
        i = self.pos + k
        return self.text[i] if i < len(self.text) else ""

    def at_comment(self) -> bool:
        """A '#' starts a comment at a line's start or after a blank."""
        return self.peek() == "#" and (self.pos == 0 or self.text[self.pos - 1] in " \t\n")

    def skip_to_eol(self) -> None:
        """Skip blanks and a comment; the line must end there."""
        while self.peek() in (" ", "\t"):
            self.pos += 1
        if self.at_comment():
            while self.peek() not in ("\n", ""):
                self.pos += 1
        if self.peek() not in ("\n", ""):
            raise self.error(f"unexpected {self.peek()!r} after a value")

    def skip_blank_lines(self) -> Optional[int]:
        """Move to the first character of the next line with content and
        return its indentation, or None at the end of the text."""
        while self.pos < len(self.text):
            start = self.pos
            while self.peek() == " ":
                self.pos += 1
            if self.peek() == "\t":
                raise self.error("a tab in the indentation")
            if self.peek() == "\n":
                self.pos += 1
                continue
            if self.peek() == "#":
                while self.peek() not in ("\n", ""):
                    self.pos += 1
                continue
            if self.peek() == "":
                return None
            return self.pos - start
        return None

    # -- scalars ---------------------------------------------------------
    def quoted(self) -> str:
        quote = self.peek()
        self.pos += 1
        out = []
        while True:
            c = self.peek()
            if c in ("", "\n"):
                raise self.error("a quoted scalar that spans lines or is not closed: "
                                 "outside the supported YAML subset")
            if c == quote:
                if quote == "'" and self.peek(1) == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            if c == "\\" and quote == '"':
                e = self.peek(1)
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.pos += 2
                elif e in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[e]
                    digits = self.text[self.pos + 2:self.pos + 2 + n]
                    if len(digits) != n or not all(d in "0123456789abcdefABCDEF"
                                                   for d in digits):
                        raise self.error(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.pos += 2 + n
                else:
                    raise self.error(f"unknown escape \\{e}")
                continue
            out.append(c)
            self.pos += 1

    def plain(self, flow: bool) -> str:
        """A plain scalar up to the line's end, a comment, ': ' (a key's
        end) and, in a flow collection, a flow indicator."""
        c = self.peek()
        if (c in _NOT_PLAIN or c in _FLOW_END or c == "#"
                or (c in "-?:" and self.peek(1) in (" ", "\t", "\n", ""))):
            raise self.error(f"{c!r} cannot start a scalar in the supported YAML subset")
        start = self.pos
        while True:
            c = self.peek()
            if c in ("", "\n") or self.at_comment():
                break
            if flow and c in _FLOW_END:
                break
            if c == ":" and (self.peek(1) in (" ", "\t", "\n", "")
                             or (flow and self.peek(1) in _FLOW_END)):
                break
            self.pos += 1
        return self.text[start:self.pos].rstrip(" \t")

    def scalar(self, flow: bool) -> Tuple[Any, bool]:
        """(value, was quoted)."""
        if self.peek() in ("'", '"'):
            return self.quoted(), True
        return resolve_plain(self.plain(flow)), False

    # -- flow collections --------------------------------------------------
    def skip_flow_space(self) -> None:
        while True:
            c = self.peek()
            if c in (" ", "\t", "\n"):
                self.pos += 1
            elif self.at_comment():
                while self.peek() not in ("\n", ""):
                    self.pos += 1
            else:
                return

    def flow_node(self) -> Any:
        self.skip_flow_space()
        c = self.peek()
        if c == "[":
            return self.flow_sequence()
        if c == "{":
            return self.flow_mapping()
        if c == "":
            raise self.error("an unclosed flow collection")
        value, _ = self.scalar(flow=True)
        return value

    def flow_sequence(self) -> list:
        self.pos += 1
        out = []
        while True:
            self.skip_flow_space()
            if self.peek() == "]":
                self.pos += 1
                return out
            out.append(self.flow_node())
            self.skip_flow_space()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() == "]":
                continue
            else:
                raise self.error(f"expected ',' or ']' in a flow sequence, got "
                                 f"{self.peek()!r} (a pair or a multi-line plain "
                                 f"scalar is outside the supported YAML subset)")

    def flow_mapping(self) -> dict:
        self.pos += 1
        out: Dict[Any, Any] = {}
        while True:
            self.skip_flow_space()
            if self.peek() == "}":
                self.pos += 1
                return out
            if self.peek() in "[{":
                raise self.error("a collection as a key: outside the supported YAML subset")
            key, _ = self.scalar(flow=True)
            self.skip_flow_space()
            if self.peek() != ":":
                raise self.error(f"expected ':' after the key {key!r} in a flow mapping")
            self.pos += 1
            self.skip_flow_space()
            out[key] = None if self.peek() in ",}" else self.flow_node()
            self.skip_flow_space()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() != "}":
                raise self.error(f"expected ',' or '}}' in a flow mapping, got {self.peek()!r}")

    # -- block mappings ----------------------------------------------------
    def block_value(self, indent: int) -> Any:
        """The value after 'key:' in a block mapping at ``indent``."""
        while self.peek() in (" ", "\t"):
            self.pos += 1
        if self.peek() in ("\n", "") or self.at_comment():
            self.skip_to_eol()
            here = self.pos
            inner = self.skip_blank_lines()
            if inner is None or inner <= indent:
                self.pos = here
                return None
            if self.peek() in "[{":
                value = self.flow_node()
                self.skip_to_eol()
                return value
            return self.block_mapping(inner)
        if self.peek() in "[{":
            value = self.flow_node()
        else:
            value, _ = self.scalar(flow=False)
            if self.peek() == ":":
                raise self.error("a mapping value on the same line as its key's value")
        self.skip_to_eol()
        return value

    def block_mapping(self, indent: int) -> dict:
        """Entries at exactly ``indent`` columns, from the current position
        (the first key's first character)."""
        out: Dict[Any, Any] = {}
        while True:
            if self.peek() in "[{":
                raise self.error("a flow collection where a key was expected")
            key, _ = self.scalar(flow=False)
            if self.peek() != ":":
                raise self.error(f"expected ':' after the key {key!r} (block sequences, "
                                 f"multi-line scalars and bare values are outside the "
                                 f"supported YAML subset)")
            self.pos += 1
            out[key] = self.block_value(indent)
            at = self.skip_blank_lines()
            if at is None or at < indent:
                # back to the line's start, for the caller's indentation check
                self.pos -= at or 0
                return out
            if at > indent:
                raise self.error("bad indentation: deeper than the mapping's keys")

    def document(self) -> Any:
        indent = self.skip_blank_lines()
        if indent is None:
            return None
        if self.text.startswith(("---", "..."), self.pos) or self.peek() == "%":
            raise self.error("document markers and directives are outside the "
                             "supported YAML subset")
        if self.peek() in "[{":
            value = self.flow_node()
            self.skip_to_eol()
        else:
            value = self.block_mapping(indent)
        if self.skip_blank_lines() is not None:
            raise self.error("bad indentation: content after the top-level mapping")
        return value


def load_yaml(text: str, name: str = "<yaml>") -> Any:
    """Parse YAML text of the supported subset (see the module docstring)
    into Python values, as ``yaml.safe_load`` would."""
    return _Reader(text, name).document()


# ----------------------------------------------------------------------
# NeatConfig
# ----------------------------------------------------------------------
def _expand_glob(pattern: str):
    """Expand a comma-separated list of glob patterns (local or gs://...)."""
    out = []
    for piece in pattern.split(","):
        piece = piece.strip()
        if not piece:
            continue
        if "://" in piece:  # remote filesystems via fsspec (tf.gfile analogue)
            import fsspec
            fs, _, paths = fsspec.get_fs_token_paths(piece)
            proto = piece.split("://", 1)[0]
            out.extend(f"{proto}://{p}" for p in sorted(paths)
                       if fs.exists(p))
        else:
            out.extend(sorted(_glob.glob(piece)))
    return out


class NeatConfig:
    """YAML-backed config with dict sections.

    Attributes: data, model, optimizer, device, downstream, validate, misc.
    """

    def __init__(self) -> None:
        self.data: Dict[str, Any] = {}
        self.model: Dict[str, Any] = {}
        self.optimizer: Dict[str, Any] = {}
        self.device: Dict[str, Any] = {}
        self.downstream: Dict[str, Any] = {}
        self.validate: Dict[str, Any] = {}
        self.misc: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_yaml(cls, config_file: str) -> "NeatConfig":
        with open(config_file, "r") as f:
            config_dict = load_yaml(f.read(), config_file)
        return cls.from_dict(config_dict, orig_config_file=config_file)

    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any],
                  orig_config_file: Optional[str] = None) -> "NeatConfig":
        config = deepcopy(config_dict)
        for key in MANDATORY_SECTIONS:
            if key not in config:
                raise ValueError(
                    f"Configuration {orig_config_file or config_dict} is missing '{key}'")
        config.setdefault("misc", {})

        if "output_dir" not in config["device"]:
            raise ValueError("Missing output directory (device.output_dir)")

        for x in ("train_file", "val_file", "test_file"):
            if x in config["data"] and isinstance(config["data"][x], str):
                config["data"][f"{x}_expanded"] = _expand_glob(config["data"][x])

        out = cls()
        for k, v in config.items():
            setattr(out, k, v)
        return out

    @classmethod
    def from_args(cls, help_message: str = "NeatConfig",
                  default_config_file: Optional[str] = None,
                  argv: Optional[Sequence[str]] = None) -> "NeatConfig":
        """From the command line's one positional YAML path; ``argv``
        replaces ``sys.argv[1:]`` when given. Unknown flags are left for
        the caller."""
        parser = argparse.ArgumentParser(description=help_message)
        parser.add_argument("config_file", nargs="?", default=default_config_file,
                            help="Path to the config.yaml")
        args, _ = parser.parse_known_args(argv)
        if not args.config_file:
            raise ValueError("No config file provided!")
        return cls.from_yaml(args.config_file)

    # ------------------------------------------------------------------
    def merged_data_model(self) -> Dict[str, Any]:
        """data-section dict updated with model keys (dataloaders read both)."""
        merged = deepcopy(self.data)
        merged.update(deepcopy(self.model))
        return merged

    def to_dict(self) -> Dict[str, Any]:
        return {k: deepcopy(getattr(self, k))
                for k in MANDATORY_SECTIONS + OPTIONAL_SECTIONS}
