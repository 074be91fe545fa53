"""merlot_tpu_torch.core.config (its own YAML reader and NeatConfig) vs
yaml.safe_load and merlot_tpu.core.config on the CPU.

The reader must give exactly what yaml.safe_load gives (YAML 1.1 scalar
resolution included: ``1e-4`` is a string, ``1.0e-4`` a float) on every
configs/*.yaml and on a string that holds each construct of the subset, and
must refuse what lies outside it. NeatConfig must equal the JAX package's
on every config, globs included. No tolerance: the values are equal.
"""

import glob
import math
import os
from pathlib import Path

import pytest
import yaml

from merlot_tpu.core.config import NeatConfig as JaxNeatConfig
from merlot_tpu_torch.core.config import NeatConfig, YamlError, load_yaml

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(glob.glob(str(REPO / "configs" / "*.yaml")))

SUBSET = """\
# a whole-line comment
data:
  train_file: "gs://bucket/train-*.tfrecord"   # a comment after a value
  hash: "a # inside double quotes"
  single: 'it''s # inside single quotes'
  empty_double: ""
  empty_single: ''
  plain: words with spaces # and a comment
  url: http://host:8080/path
  escapes: "tab\\tnewline\\nquote\\"unicode\\u00e9"

numbers:
  as_string: 1e-4
  as_float: 1.0e-4
  also_float: 6.02e+23
  lr: 0.0003
  neg: -3
  neg_float: -0.5
  plus: +7
  zero: 0
  octal: 012
  not_octal: 09
  hex: 0x1F
  underscores: 1_000
  sexagesimal: 1:30
  dot_leading: .5
  inf: -.inf
  nan_like: .nan
  quoted_number: "1.0"

flags:
  t: true
  f: false
  cap: True
  yes_word: yes
  off_word: Off
  tilde: ~
  null_word: null
  bare:

nested:
  deeper:
    deepest: {a: 1, "b": [x, 'y', 2.5,], c: }
  after: 1

flow: [
  [["attn_ln", "mlp_ln",
    "final_ln"],   # a comment inside a flow collection
   {"weight_decay_rate": 0, lr: 1.0e-4, tags: [a, b,],}],
  [],
  {},
]
value_below:
  [1, 2]
"""


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_reader_matches_safe_load_on_configs(path):
    text = Path(path).read_text()
    assert load_yaml(text, path) == yaml.safe_load(text)


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


def test_reader_matches_safe_load_on_the_subset():
    got, want = load_yaml(SUBSET), yaml.safe_load(SUBSET)
    assert _same(got, want), (got, want)
    assert got["numbers"]["as_string"] == "1e-4"
    assert got["numbers"]["as_float"] == 1.0e-4
    assert got["numbers"]["octal"] == 10 and got["numbers"]["not_octal"] == "09"
    assert got["data"]["hash"] == "a # inside double quotes"
    assert got["flags"]["bare"] is None and got["data"]["empty_double"] == ""


@pytest.mark.parametrize("text", [
    "a: &anchor 1", "a: *alias", "- item", "a:\n  - item", "a: |\n  block",
    "a: >\n  folded", "a: b: c", "a: [1,\n 2", "---\na: 1", "%YAML 1.1\na: 1",
    "a: !!str 1", "a:\n  b\n  c", "a: 2001-12-14", 'a: "spans\n lines"',
    "a: 1\n   b: 2", "a: [k: v]", "a:\n\tb: 1", "a: {[1]: 2}", "<<: 1",
], ids=lambda t: t.replace("\n", "|"))
def test_reader_refuses_outside_the_subset(text):
    with pytest.raises(YamlError):
        load_yaml(text)


def _with_paths(text, **paths):
    for key, value in paths.items():
        text = text.replace(f'{key}: "TRAIN_FILE_PATH"', f'{key}: "{value}"')
    return text


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_neat_config_matches_jax(path, tmp_path):
    for name in ("train-0.tfrecord", "train-1.tfrecord", "other.tfrecord"):
        (tmp_path / name).write_bytes(b"")
    text = Path(path).read_text().replace(
        '"TRAIN_FILE_PATH"', f'"{tmp_path}/train-*.tfrecord, {tmp_path}/other*"')
    cfg_file = tmp_path / "config.yaml"
    cfg_file.write_text(text)
    got, want = NeatConfig.from_yaml(str(cfg_file)), JaxNeatConfig.from_yaml(str(cfg_file))
    assert got.to_dict() == want.to_dict()
    assert got.data["train_file_expanded"] == want.data["train_file_expanded"]
    assert len(got.data["train_file_expanded"]) == 3
    assert got.merged_data_model() == want.merged_data_model()
    argv = [str(cfg_file), "--device", "cpu"]
    assert NeatConfig.from_args(argv=argv).to_dict() == want.to_dict()


def test_neat_config_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="missing 'model'"):
        NeatConfig.from_dict({"data": {}, "optimizer": {}, "device": {}})
    with pytest.raises(ValueError, match="output_dir"):
        NeatConfig.from_dict({"data": {}, "model": {}, "optimizer": {}, "device": {}})
    with pytest.raises(ValueError, match="No config file"):
        NeatConfig.from_args(argv=[])
