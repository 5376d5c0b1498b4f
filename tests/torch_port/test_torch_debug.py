"""tracer_torch.utils.debug.checked, the counterpart of the reference's
checkify guard (tests/unit/test_debug_guards.py): a clean Cornell frame
passes and equals the unchecked one; NaN vertices raise CheckError; an
index outside its dimension raises CheckError before the indexing op runs,
for each indexing op the guard covers; a NaN that reaches the output past
the dispatcher (as a ctypes kernel's would) raises too."""
import dataclasses

import numpy as np
import pytest
import torch

from tracer_torch.api import get_scene
from tracer_torch.render.whitted import WhittedConfig, render_image
from tracer_torch.utils.config import load_config
from tracer_torch.utils.debug import CheckError, checked


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(size):
    return checked(lambda s, c: render_image(s, c, size, size, WhittedConfig(max_bounces=1)))


def test_clean_render_passes_checks():
    scene, cam = get_scene(load_config("cornell256"), "cpu")
    img = _run(16)(scene, cam)
    assert torch.isfinite(img).all() and img.max() > 0.05
    assert torch.equal(img, render_image(scene, cam, 16, 16, WhittedConfig(max_bounces=1)))


def test_nan_input_is_caught():
    scene, cam = get_scene(load_config("cornell256"), "cpu")
    verts = scene.verts.clone()
    verts[0, 0] = float("nan")
    with pytest.raises(CheckError, match="NaN"):
        _run(8)(dataclasses.replace(scene, verts=verts), cam)


OPS = {
    "index": lambda x, i: x[i],
    "index_select": lambda x, i: x.index_select(0, i),
    "gather": lambda x, i: x.gather(0, i),
    "take": lambda x, i: torch.take(x, i),
    "index_add_": lambda x, i: x.clone().index_add_(0, i, torch.ones(i.shape[0])),
    "index_put_": lambda x, i: x.clone().index_put_((i,), torch.ones(i.shape[0])),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_out_of_range_index_is_caught(op):
    x = torch.arange(10, dtype=torch.float32)
    ok = OPS[op](x, torch.tensor([0, 9]))
    assert torch.equal(checked(OPS[op])(x, torch.tensor([0, 9])), ok)
    with pytest.raises(CheckError, match="out of"):
        checked(OPS[op])(x, torch.tensor([1, 10]))


def test_negative_index_wraps_where_torch_wraps():
    """x[-1] is the last row, not an error: the guard takes Python's range
    for advanced indexing and refuses below -size."""
    x = torch.arange(10, dtype=torch.float32)
    assert torch.equal(checked(lambda i: x[i])(torch.tensor([-1, -10])), torch.tensor([9., 0.]))
    with pytest.raises(CheckError):
        checked(lambda i: x[i])(torch.tensor([-11]))


def test_nan_in_output_past_the_dispatcher():
    """A tensor made outside any ATen op (numpy here, a ctypes kernel on the
    card) is checked when the wrapped function returns it, inside tuples,
    dicts and dataclasses too."""
    @dataclasses.dataclass
    class Out:
        img: torch.Tensor

    made = torch.from_numpy(np.array([1.0, np.nan], np.float32))
    with pytest.raises(CheckError, match="output tensors"):
        checked(lambda: {"a": (Out(made),)})()
    good = checked(lambda: (Out(torch.from_numpy(np.ones(2, np.float32))),))()
    assert good[0].img.sum() == 2
