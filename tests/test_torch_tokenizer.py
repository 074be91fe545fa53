"""The port's tokenizers against the JAX package's: identical ids for text
with accents, CJK, digits, superscripts, Roman numerals, emoji and runs of
whitespace (exact: ids feed checkpoints), the same special-token layout,
and the port's pretokenizer runs without the third-party ``regex`` module
(the card's machine has none)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from merlot_tpu.core import tokenizer as jax_tok
from merlot_tpu_torch.core import tokenizer as port_tok

REPO = Path(__file__).resolve().parents[1]

TEXTS = [
    "so today were gonna make pasta",
    "Café naïve résumé — déjà vu, Ångström",
    "東京タワー 你好，世界！ 한국어 テスト",
    "123 4567 3.14159 x² H₂O Ⅻ ½ ¾ ١٢٣",
    "emoji 😀🎉👍🏽 and ZWJ 👨‍👩‍👧",
    "tabs\tand\nnewlines\n\n   trailing   spaces   　ideographic nbsp",
    "it's we'll I'd they're you've I'm   ok\x1c\x1dcontrol",
    "",
]


@pytest.fixture(scope="module")
def grover_pair():
    return jax_tok.get_grover_tokenizer(), port_tok.get_grover_tokenizer()


@pytest.mark.parametrize("text", TEXTS)
def test_grover_ids_match_jax(grover_pair, text):
    jt, pt = grover_pair
    ids = pt.encode(text)
    assert ids == jt.encode(text)
    assert pt.decode(ids) == jt.decode(ids)


def test_merlot_ids_match_jax():
    jt, pt = jax_tok.get_tokenizer(), port_tok.get_tokenizer()
    for text in TEXTS:
        assert pt.encode(text) == jt.encode(text)
    assert pt.encoder == jt.encoder
    assert pt.padded_vocab_size == jt.padded_vocab_size


def test_grover_special_layout_matches_jax(grover_pair):
    jt, pt = grover_pair
    assert pt.encoder == jt.encoder
    for field in pt.SPECIAL_FIELDS:
        for side in ("begin", "end"):
            assert getattr(pt, f"{side}_{field}") == getattr(jt, f"{side}_{field}")
    assert (pt.padding, pt.reset_context, pt.padded_vocab_size) == \
        (jt.padding, jt.reset_context, jt.padded_vocab_size) == (0, 50269, 50270)
    assert "<|endoftext|>" not in pt.encoder
    assert pt.special_tokens_onehot == jt.special_tokens_onehot


def test_tokenizer_runs_without_regex():
    """A fresh interpreter in which ``import regex`` fails still encodes,
    with the ids the JAX tokenizer gives (passed in)."""
    jt = jax_tok.get_grover_tokenizer()
    script = (
        "import sys; sys.modules['regex'] = None\n"
        "from merlot_tpu_torch.core.tokenizer import get_grover_tokenizer\n"
        f"texts = {TEXTS!r}\n"
        "print([get_grover_tokenizer().encode(t) for t in texts])\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == repr([jt.encode(t) for t in TEXTS])
