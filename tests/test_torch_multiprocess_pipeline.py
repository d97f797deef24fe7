"""Pipelined training across processes, on the CPU: `pipeline_forward`
under a loss (GPipe's backward, `parallel/pipeline.py::_GPipeAcross`) in
2 processes x 2 CPU ranks started by the launcher, as
tests/test_torch_multiprocess.py starts the other paths. One launch runs
`utils/multiprocess_paths.py`'s pipe_train path on the small fp32 model
at pp=2 (one rank of each process), pp=2·dp=2 (each pipe spans both
processes) and pp=2 over `stage_param_sharding`'s placed stages; process
0's loss and gradients are held bit for bit to the same step in one
process on repeated "cpu" ranks, and the pp=2·dp=2 step to
`jax.value_and_grad` over JAX's `pipeline_forward` (1e-5 on the loss,
1e-4 · max per gradient). The child runs under a 120 s timeout."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.models import transformer as jtf
from cuda_flashattention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cuda_flashattention_torch.models import transformer as ttf
from cuda_flashattention_torch.models.convert import (
    params_from_jax,
    params_to_jax,
)
from cuda_flashattention_torch.parallel.mesh import make_mesh
from cuda_flashattention_torch.utils import multiprocess_paths as mp
from cuda_flashattention_torch.utils.testing import assert_close, max_abs

REPO = Path(__file__).resolve().parent.parent
GATE = 1e-4
KW, _ = mp.MODELS["tiny"]
JCFG = jtf.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttf.TransformerConfig(dtype=torch.float32, **KW)
TRAIN_T = 32
# pp over one rank of each process, pp x dp over all four (each pipe spans
# both processes), and pp over `stage_param_sharding`'s placed stages
PIPE_FORMS = {"pp": "pp=2", "pp_dp": "pp=2,dp=2", "pp_placed": "pp=2:placed"}
PIPE_B, PIPE_MICRO = 4, 2


def launch(*target):
    """The launcher at 2 processes x 2 CPU ranks over `target` (-m MODULE
    ...), under a 120 s timeout."""
    r = subprocess.run(
        [sys.executable, "-m", "cuda_flashattention_torch.scripts."
         "launch_multihost", "-np", "2", "--devices-per-proc", "2", "--cpu",
         *target], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, f"rc={r.returncode}\n{r.stdout}\n{r.stderr}"
    return r.stdout


def _grads(saved):
    return {k[5:]: v for k, v in saved.items() if k.startswith("grad/")}


def _jax_pipe_loss(params, tokens, mesh, batch_axis):
    logits = jtf.pipeline_forward(params, tokens, JCFG, mesh,
                                  n_micro=PIPE_MICRO, batch_axis=batch_axis)
    logp = jax.nn.log_softmax(logits, axis=-1)
    targets = jnp.roll(tokens, -1, axis=1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return nll[:, :-1].mean()


@pytest.fixture(scope="module")
def pipe_train(tmp_path_factory):
    """The weights (JAX's init, converted), the tokens, and each pipelined
    form's saved loss and gradients from one launch of every form."""
    tmp = tmp_path_factory.mktemp("pipe")
    jparams = jtf.init_params(jax.random.PRNGKey(0), JCFG)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            TCFG)
    torch.save(model.state_dict(), tmp / "weights.pt")
    launch("-m", "cuda_flashattention_torch.utils.multiprocess_paths",
           "--out", str(tmp), "--save", "pipe_train",
           *(a for spec in PIPE_FORMS.values() for a in ("--pipe-axes",
                                                         spec)),
           "--weights", str(tmp / "weights.pt"), "--batch", str(PIPE_B),
           "--seq", str(TRAIN_T), "--micro", str(PIPE_MICRO), "--steps", "1")
    saved = {form: dict(np.load(tmp / f"pipe_train[{spec}].npz"))
             for form, spec in PIPE_FORMS.items()}
    tokens = np.random.default_rng(1).integers(
        0, KW["vocab_size"], (PIPE_B, TRAIN_T)).astype(np.int32)
    return jparams, tokens, saved


@pytest.mark.parametrize("form", list(PIPE_FORMS))
def test_pipe_train_matches_one_process(pipe_train, form):
    """The loss and every parameter's gradient of the pipelined step
    across 2 processes, bit for bit the same step in one process on a mesh
    of repeated "cpu" ranks (the placed stages' layers gathered from the
    process that holds each)."""
    jparams, tokens, saved = pipe_train
    axes, _, mode = PIPE_FORMS[form].partition(":")
    shape = tuple(int(a.split("=")[1]) for a in axes.split(","))
    names = tuple(a.split("=")[0] for a in axes.split(","))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            TCFG)
    mesh = make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))
    loss = mp.pipe_loss(model, torch.from_numpy(tokens), mesh, PIPE_MICRO,
                        "dp" if "dp" in names else None, mode == "placed")
    loss.backward()
    got = saved[form]
    np.testing.assert_array_equal(got["loss"], loss.detach().numpy())
    grads = _grads(got)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        assert max_abs(p.grad.numpy()) > 0
        np.testing.assert_array_equal(grads[n], p.grad.numpy(),
                                      err_msg=f"{form} {n}")


def test_pipe_train_matches_jax(pipe_train):
    """The pp=2·dp=2 step's loss and gradients against
    `jax.value_and_grad` of the same loss over JAX's `pipeline_forward` on
    a (pp, dp) mesh of the virtual CPU devices."""
    jparams, tokens, saved = pipe_train
    jmesh = jax_make_mesh((2, 2), ("pp", "dp"), jax.devices()[:4])
    loss_j, grads_j = jax.value_and_grad(
        lambda p: _jax_pipe_loss(p, jnp.asarray(tokens), jmesh, "dp"))(
            jparams)
    got = saved["pp_dp"]
    assert abs(float(got["loss"]) - float(loss_j)) <= 1e-5
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            TCFG)
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(_grads(got)[n])
    got_j = params_to_jax(model, grads=True)
    for (path, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(got_j),
            jax.tree_util.tree_leaves_with_path(
                jax.tree_util.tree_map(np.asarray, grads_j))):
        assert_close(g, w, GATE * max_abs(w),
                     f"pp_dp grad {jax.tree_util.keystr(path)}")
