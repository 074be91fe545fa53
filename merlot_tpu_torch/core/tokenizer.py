"""Special token ids (counterpart of the constants of
merlot_tpu/core/tokenizer.py; the BPE tokenizer itself is not ported)."""

PADDING = 0
MASK = 1
SPECIAL_TOKEN_CUTOFF = 100  # ids below this are special / reserved
