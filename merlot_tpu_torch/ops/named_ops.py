"""Whether the hand-written kernels' forwards (K1's
``cuda_attention.attention_fwd_op``, K5's ``cuda_ln_matmul.ln_matmul_op``)
run through their dispatcher ops.

Each is a ``torch.library`` custom op so that torch's selective
checkpoint can name it (``nn.transformer``'s remat policies). A call
through the op costs the host about 0.055 ms more than calling its body
(``chip_smoke.py --dispatch-cost`` on an H100), so the wrappers call the
body, and go through the op only inside ``through_ops()``: a layer
checkpointed under a policy that names ops enters it for its forward and
for its recompute. The switch is per thread, as the recompute runs in
the thread of the backward that enters it.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def active() -> bool:
    """True inside ``through_ops()`` on this thread."""
    return getattr(_state, "on", False)


@contextlib.contextmanager
def through_ops():
    """Route the kernels' forwards through their dispatcher ops inside the
    block, on this thread."""
    before = active()
    _state.on = True
    try:
        yield
    finally:
        _state.on = before
