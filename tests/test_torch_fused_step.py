"""The fused-norm slice: one pretrain train step and one zero-shot forward
of merlot_tpu_torch with both fused norms on (``fuse_ln_matmul=True`` and
the GroupNorm backend 'cuda', which on the CPU runs the plain versions of
K4 and K5 through their autograd Functions) against merlot_tpu with its
Pallas kernels in interpret mode (``pallas_groupnorm`` backend 'pallas'
under ``force_tpu_interpret_mode``, ``pallas_ln_matmul.INTERPRET``).

The config is small enough for the CPU and one the JAX kernels take:
hidden 128, intermediate 256, 2 layers per tower, LiteResNet (1, 1, 1),
64x96 frames, fp32. Tolerances: the step's are those of the step checks
in ``torch_port_helpers`` (with fp32 noise in the grads passed on to the
new params); zero-shot probs 1e-5 (a softmax of logits from
two 2-layer towers summed in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import merlot_tpu.ops.pallas_ln_matmul as plm
from merlot_tpu.downstream.sort_story.zero_shot import \
    make_zero_shot_fn as jax_make_zero_shot_fn
from merlot_tpu.models.config import MerlotConfig as JaxConfig
from merlot_tpu.ops import pallas_groupnorm as pgn
from merlot_tpu_torch.convert import load_flax_params
from merlot_tpu_torch.downstream.sort_story.zero_shot import make_zero_shot_fn
from merlot_tpu_torch.models.config import MerlotConfig
from merlot_tpu_torch.models.merlot import MerlotModel
from merlot_tpu_torch.ops import cuda_groupnorm, cuda_ln_matmul, norms
from torch_port_helpers import (check_step_grads, check_step_loss_and_metrics,
                                check_step_params_and_state, flat_params, step_both,
                                tiny_config)

SMALL = dict(hidden_size=128, intermediate_size=256, fuse_ln_matmul=True)
# The step's frames. Two sums of the same fp32 terms in another order move
# a pre-ReLU value by ~1e-7; one value within that of 0 then flips its ReLU
# and moves a stem conv kernel's grad by up to 4e-3 of its largest (a
# kernel's grad nearly cancels under weight standardization): measured
# when the frames of tiny_batch held a value 3.8e-7 from 0. The frames of
# this seed keep every pre-ReLU value of the stem at least 1.6e-6 from 0
# (``relu_margin``).
IMAGE_SEED = 73


def relu_margin(model, images):
    """The smallest |pre-ReLU value| over the stem's GroupNorm+ReLU sites
    in the port's ViT forward on ``images``."""
    margins = []
    unfused = norms.group_norm_act

    def pre_relu(x, gamma, beta, *, residual=None, relu=False, **kw):
        out = unfused(x, gamma, beta, residual=residual, **kw)
        if relu:
            margins.append(out.abs().min().item())
        return torch.relu(out) if relu else out

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(cuda_groupnorm, "BACKEND", "plain")
        mp.setattr(norms, "group_norm_act", pre_relu)
        model.merlot.vision_backbone(torch.from_numpy(np.array(images)),
                                     attn_backend="plain", deterministic=True)
    return min(margins)


@pytest.fixture(scope="module")
def fused_kernels():
    """Both packages' fused norms on, for the module's tests; counts the
    port's K4 and K5 Function calls."""
    calls = {"gn": 0, "ln": 0}
    mp = pytest.MonkeyPatch()
    for mod, name in ((cuda_groupnorm.GroupNormAct, "gn"), (cuda_ln_matmul.LnMatmul, "ln")):
        orig = mod.apply

        def counted(*a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*a)
        mp.setattr(mod, "apply", counted)
    mp.setattr(cuda_groupnorm, "BACKEND", "cuda")
    mp.setattr(pgn, "BACKEND", "pallas")
    mp.setattr(pgn, "TRAIN_BACKEND", "pallas")
    mp.setattr(plm, "INTERPRET", True)
    with pltpu.force_tpu_interpret_mode():
        yield calls
    mp.undo()


@pytest.fixture(scope="module")
def stepped(fused_kernels):
    cfg = tiny_config(**SMALL)
    # the ViT (8 frames x 26 rows) and lang (4 x 16) towers run the Pallas
    # kernel; the joint tower's 4 x 30 rows have no 16-row block, so JAX
    # runs its unfused math there (the same function)
    for m, supported in ((8 * 26, True), (4 * 16, True), (4 * 30, False)):
        assert (plm.kernel_supported(m, 128, 128, 4, j=3) is not None) == supported
    margins = []
    out = step_both(cfg, image_seed=IMAGE_SEED, before_step=lambda tm, batch: (
        margins.append(relu_margin(tm, batch["images"])), fused_kernels.update(gn=0, ln=0)))
    assert margins[0] > 1e-6
    # one forward: 15 GroupNorms, 3 towers x 2 layers x 2 sites
    assert fused_kernels == {"gn": 15, "ln": 12}
    return out


def test_fused_step_loss_and_metrics_match_jax(stepped):
    check_step_loss_and_metrics(stepped)


def test_fused_step_grads_match_jax(stepped):
    check_step_grads(stepped)


def test_fused_step_params_and_state_match_jax(stepped):
    # the fused paths' grads differ by fp32 noise (measured up to 3.5e-7 of
    # a tensor's largest |grad|: the Pallas kernel's products and the port's
    # sum in other orders), which Adam passes on 42-fold to elements whose
    # |grad| is far below epsilon (``check_step_params_and_state``)
    check_step_params_and_state(stepped, grad_noise=1e-6)


BATCH, N, DUP = 2, 4, 2


def _init_all(mdl, imgs, sents, sidx):
    """Touch every parameter, so that the tree fills the port's model."""
    fwd = mdl(imgs, sents, mask_input=False, shuffled_idx_img=sidx, deterministic=True)
    mdl.embed_words(sents.reshape(sents.shape[0], -1), which="langonly")
    mdl.contrastive_features(fwd["img_trg_h"], fwd["img_trg_h"])
    mdl.lm_logits(fwd["encoder_hidden_states"]["lang"])
    x = fwd["encoder_hidden_states"]["viz"][:, :N]
    mdl.temporal_logits(x, x, which="lang_viz")
    mdl.temporal_logits(x, x, which="viz_viz")
    return 0


def test_fused_zero_shot_matches_jax(fused_kernels):
    """The zero-shot forward (deterministic: the GroupNorm ``BACKEND``),
    both fused norms on, against JAX's with both Pallas kernels. 16 frames
    of 64x96 give ViT rows 16 x 26 and joint rows 4 x 156, both taken by
    the JAX kernel's sizer."""
    kw = dict(dataclasses.asdict(tiny_config(**SMALL)), num_chunks_in_group=N)
    jcfg = JaxConfig(**kw)
    for m, j, n in ((16 * 26, 3, 128), (4 * 156, 1, 256)):
        assert plm.kernel_supported(m, 128, n, 4, j=j) is not None
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (BATCH, N, 64, 96, 3)).astype(np.float32)
    sents = rng.integers(100, 50357, (BATCH, N, 32)).astype(np.int32)
    for b in range(BATCH):
        for i in range(N):
            sents[b, i, rng.integers(4, 32):] = 0
    model, jfn, _ = jax_make_zero_shot_fn(jcfg, BATCH, N)
    key = jax.random.fold_in(jax.random.PRNGKey(123), 1234)
    u = jax.random.uniform(key, (BATCH * DUP * N,))
    sidx = np.asarray(jnp.argsort(u.reshape(BATCH * DUP, N), axis=1)) + 64
    imgs_dup = jnp.tile(jnp.asarray(images), (DUP, 1, 1, 1, 1)).reshape(-1, 64, 96, 3)
    sents_dup = jnp.tile(jnp.asarray(sents), (DUP, 1, 1))
    variables = jax.jit(lambda k: model.init(k, imgs_dup, sents_dup, jnp.asarray(sidx),
                                             method=_init_all))(jax.random.PRNGKey(0))
    want = jfn(variables, jnp.asarray(images), jnp.asarray(sents))

    tm = MerlotModel(MerlotConfig(**dataclasses.asdict(jcfg.eval_mode())))
    load_flax_params(tm, flat_params(variables["params"]))
    fused_kernels.update(gn=0, ln=0)
    got = make_zero_shot_fn(BATCH, N, shuffled_idx=torch.from_numpy(sidx))(
        tm, torch.from_numpy(images), torch.from_numpy(sents))
    assert fused_kernels == {"gn": 15, "ln": 8}     # ViT and joint, 2 layers x 2 sites
    for name in ("lang_viz", "viz_viz"):
        np.testing.assert_allclose(got[f"{name}_probs"].numpy(),
                                   np.asarray(want[f"{name}_probs"]), atol=1e-5, rtol=1e-5)
