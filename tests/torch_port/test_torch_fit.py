"""tracer_torch.diff.fit's loop against the JAX package's on the CPU, and its
checkpoints: 5 steps of fit in the replay mode and the jnp mode on
bunny-grad (subdiv 2; the replay mode with use_bvh off) against the
reference's fit (optax.adam against torch.optim.Adam with eps 1e-8), a
resume from a reference state carried across by
tracer_torch.bridge.fit_state_from_arrays, checkpoint/resume, a write
killed half way, and a SIGKILL mid-run in a child process that imports no
JAX, then a resume (tests/grad/test_fit.py's fault injection).

Problems as test_torch_fit_modes.py's, at 16x16, verts and albedo
optimized. Tolerance: losses rtol 1e-4 over 5 steps. Not on cornell256: its
flat walls give vertex gradients at the noise level (up to 2.4e-7 against
a largest entry of 7.3; 32 of 108 entries of opposite sign in the two
packages), which Adam's first step turns into whole steps of the learning
rate, so that by the fifth step the losses differ by 3 %."""
import dataclasses
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tracer.diff.fit import FitConfig as JFitConfig
from tracer.diff.fit import fit as j_fit
from tracer.diff.fit import init_params as j_init_params
from tracer.diff.fit import make_loss_fn as j_make_loss_fn
from tracer_torch.bridge import fit_state_from_arrays
from tracer_torch.diff import fit as fit_loop  # the function, re-exported
from tracer_torch.diff.fit import FitConfig, latest_checkpoint, save_checkpoint

from test_torch_fit_modes import problem
from torch_fit_problem import CFG as TORCH_CFG
from torch_fit_problem import torch_problem

LR = 5e-3
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BUNNY = {"replay": ("bunny-grad", {"scene_arg": 2, "use_bvh": False}, False),
         "jnp": ("bunny-grad", {"scene_arg": 2}, False)}


@pytest.mark.parametrize("mode", list(BUNNY))
def test_fit_matches_reference(mode):
    """The losses of 5 Adam steps: the port's fit against the reference's."""
    j_cfg, cfg, fcfg, j_scene, j_cam, scene, camera, target = problem(*BUNNY[mode])
    fcfg = dataclasses.replace(fcfg, steps=5, learning_rate=LR)
    _, want = j_fit(j_scene, j_cam, jnp.asarray(target), j_cfg,
                    JFitConfig(**dataclasses.asdict(fcfg)))
    params, got = fit_loop(scene, camera, torch.as_tensor(target), cfg, fcfg)
    assert len(got) == 5 and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert set(params) == {"vert_offset", "albedo"}
    assert not any(p.requires_grad for p in params.values())


def test_resume_from_reference_state(tmp_path):
    """The reference runs 3 steps by hand (its loss and optax.adam); its
    parameters and Adam moments go through fit_state_from_arrays into a
    port checkpoint at step 2, from which the port's fit runs steps 3 and
    4: their losses are the reference's steps 3 and 4."""
    j_cfg, cfg, fcfg, j_scene, j_cam, scene, camera, target = problem(*BUNNY["replay"])
    fcfg = dataclasses.replace(fcfg, steps=5, learning_rate=LR)
    j_fcfg = JFitConfig(**dataclasses.asdict(fcfg))
    loss_fn = j_make_loss_fn(j_scene, j_cam, jnp.asarray(target), j_cfg, j_fcfg)
    opt = optax.adam(LR)

    @jax.jit
    def step(params, state):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, state = opt.update(grads, state, params)
        return loss, optax.apply_updates(params, updates), state

    params = j_init_params(j_scene, j_fcfg)
    state = opt.init(params)
    want = []
    for i in range(5):
        if i == 3:
            adam = state[0]
            names = ("vert_offset", "albedo")  # init_params' order
            t_params, t_state = fit_state_from_arrays(
                *({k: np.asarray(tree[k]) for k in names} for tree in (params, adam.mu, adam.nu)),
                int(adam.count), "cpu")
            t_opt = torch.optim.Adam(t_params.values(), lr=LR, eps=1e-8)
            t_opt.load_state_dict({"state": t_state,
                                   "param_groups": t_opt.state_dict()["param_groups"]})
            save_checkpoint(str(tmp_path), 2, t_params, t_opt)
        loss, params, state = step(params, state)
        want.append(float(loss))
    _, got = fit_loop(scene, camera, torch.as_tensor(target), cfg,
                      dataclasses.replace(fcfg, checkpoint_dir=str(tmp_path)))
    assert len(got) == 2
    np.testing.assert_allclose(got, want[3:], rtol=1e-4)


def test_checkpoint_resume_continues_from_step(tmp_path):
    """6 steps checkpointed every 3, then a resume to 9 runs exactly the 3
    steps left, from the progress made (tests/grad/test_fit.py's test)."""
    scene, cam, target = torch_problem()
    ck = str(tmp_path / "ck")
    _, losses_a = fit_loop(scene, cam, target, TORCH_CFG,
                           FitConfig(steps=6, learning_rate=LR, checkpoint_every=3,
                                     checkpoint_dir=ck))
    assert latest_checkpoint(ck)[0] == 5
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000005"]
    _, losses_b = fit_loop(scene, cam, target, TORCH_CFG,
                           FitConfig(steps=9, learning_rate=LR, checkpoint_every=3,
                                     checkpoint_dir=ck))
    assert len(losses_b) == 3 and np.isfinite(losses_b).all()
    assert losses_b[0] < losses_a[0], "the resumed loss must reflect the progress made"
    assert latest_checkpoint(ck)[0] == 8


def test_killed_write_is_never_taken(tmp_path, monkeypatch):
    """A save killed while it writes leaves step_N.tmp and no step_N:
    latest_checkpoint keeps answering the last complete checkpoint."""
    scene, cam, target = torch_problem()
    params = {"vert_offset": torch.zeros_like(scene.verts, requires_grad=True)}
    opt = torch.optim.Adam(params.values(), lr=LR)
    save_checkpoint(str(tmp_path), 3, params, opt)

    def half_write(obj, f):
        f.write(b"\x80\x02half a checkpoint")
        raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(torch, "save", half_write)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(str(tmp_path), 6, params, opt)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000006.tmp"]
    step, path = latest_checkpoint(str(tmp_path))
    assert step == 3 and path.endswith("step_00000003")


_CHILD = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {here!r})
from torch_fit_problem import CFG, torch_problem
from tracer_torch.diff.fit import FitConfig, fit
scene, cam, target = torch_problem()
print('CHILD_START jax imported:', any(m == 'jax' or m.startswith(('jax.', 'tracer.'))
                                       or m == 'tracer' for m in sys.modules), flush=True)
fit(scene, cam, target, CFG, FitConfig(steps=100000, learning_rate={lr}, checkpoint_every=3,
                                       checkpoint_dir={ck!r}))
"""


def test_kill_mid_run_then_resume(tmp_path):
    """SIGKILL a fit in a child process (torch only: it imports neither JAX
    nor the JAX package) once checkpoints exist; a resume continues from the
    last checkpoint and runs exactly the steps left."""
    ck = str(tmp_path / "ck")
    code = _CHILD.format(root=ROOT, here=os.path.dirname(os.path.abspath(__file__)), ck=ck,
                         lr=LR)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        assert first.strip() == "CHILD_START jax imported: False", first + proc.stderr.read()
        deadline = time.time() + 240
        step = None
        while time.time() < deadline:
            step, _ = latest_checkpoint(ck)
            if step is not None and step >= 5:
                break
            assert proc.poll() is None, "the fit child exited before checkpointing"
            time.sleep(0.2)
        assert step is not None and step >= 5, "no checkpoint appeared in time"
        proc.send_signal(signal.SIGKILL)
    finally:
        proc.kill()
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()
    killed_at, _ = latest_checkpoint(ck)
    assert killed_at is not None and killed_at >= 5
    scene, cam, target = torch_problem()
    _, losses = fit_loop(scene, cam, target, TORCH_CFG,
                         FitConfig(steps=killed_at + 4, learning_rate=LR, checkpoint_every=3,
                                   checkpoint_dir=ck))
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert latest_checkpoint(ck)[0] == killed_at + 3
