"""The benchmark's arithmetic against hand-worked cases: p95, device busy
time and idle gaps, the roofline counts, TF32 rounding and the checks."""
from types import SimpleNamespace as N

import pytest
import torch
from torch.autograd import DeviceType

from rtbench import checks, harness, reference, roofline, spans

C, H = DeviceType.CUDA, DeviceType.CPU


def ev(a, b, dev, name="k", ann=False, thread=1):
    return N(time_range=N(start=a, end=b), name=name, device_type=dev,
             is_user_annotation=ann, thread=thread)


def test_p95_nearest_rank():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([3.0]) == 3.0
    assert harness.p95([5, 1, 4, 2, 3]) == 5        # ceil(4.75) = 5th of 5
    assert harness.p95(list(range(1, 21))) == 19    # ceil(19) = 19th


def test_busy_is_the_union_of_device_intervals():
    evs = [ev(0, 10, C), ev(5, 12, C), ev(20, 30, C), ev(0, 100, H),
           ev(0, 40, C, ann=True)]                   # a user annotation is no activity
    assert spans.busy_ms(evs) == pytest.approx(0.022)
    assert spans.device_intervals(evs) == [(0, 12), (20, 30)]


def test_idle_gaps_name_what_the_host_was_doing():
    evs = [ev(0, 10, C), ev(15, 20, C), ev(40, 50, C),
           ev(0, 60, H, "cull", ann=True), ev(9, 18, H, "aten::item"),
           ev(10, 17, H, "cudaStreamSynchronize"), ev(25, 45, H, "aten::sort"),
           ev(0, 60, H, "other thread", thread=2)]
    assert spans.idle_gaps(evs) == [["cull > python", pytest.approx(20e-6)],
                                    ["cull > cudaStreamSynchronize", pytest.approx(5e-6)]]


def test_short_names():
    assert spans.short_name("void at::native::gather<16, long>(char*, long)") == \
        "at::native::gather<16, long>"
    assert spans.short_name("(anonymous namespace)::anyhit_kernel(int const*)") == "anyhit_kernel"


def test_bound_takes_the_larger_of_operations_and_bytes():
    # 67e9 operations: 1 ms; 3.35e9 bytes: 1 ms.
    assert roofline.bound_ms(67e9, 0, 64, 0, 0, 32, 8) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 0, 64, 0, 3_350_000_000, 32, 8) == pytest.approx(1.0)
    # 10 tiles of 64 rays, 40 B a ray, 4 B for 6 items and 10 tiles, 4800 B of clusters.
    nbytes = 10 * 64 * 40 + 4 * 16 + 4800
    assert roofline.bound_ms(0, 10, 64, 6, 4800, 32, 8) == pytest.approx(nbytes / 3.35e9)


def word(t: float, cluster: int) -> int:
    b = int(torch.tensor(t, dtype=torch.float32).view(torch.int32))
    return (b & ~roofline.CL_MASK) | cluster


def test_closest_counts_the_words_under_the_final_bound():
    inv = 0x7FFFFFFF
    words = torch.tensor([[word(1.0, 3), word(2.0, 5), word(8.0, 7), inv],    # bound 4: 2 words
                          [word(1.0, 3), inv, inv, inv],                      # count 1: 1 word
                          [inv, inv, inv, inv]], dtype=torch.int32)           # empty
    counts = torch.tensor([3, 1, 0], dtype=torch.int32)
    bt = torch.tensor([[4.0, 3.0], [1.5, 1e30], [1e30, 1e30]])
    tr, c = 2, 4
    want = (roofline.bound_ms(2 * tr * c * 41, 1, tr, 2, 2 * 48 * c, 32, 8)
            + roofline.bound_ms(1 * tr * c * 41, 1, tr, 1, 1 * 48 * c, 32, 8))
    assert roofline.closest_split_ms(words, counts, bt, tr, c) == pytest.approx(want)


def test_anyhit_counts_per_open_ray():
    inv = 0x7FFFFFFF
    words = torch.tensor([[word(1.0, 2), word(3.0, 4), inv]], dtype=torch.int32)
    counts = torch.tensor([2], dtype=torch.int32)
    occ = torch.tensor([[False, True, False]])
    tmax = torch.tensor([[2.0, 5.0, 5.0]])   # ray 0 reaches word 0, ray 2 both
    c = 4
    tests = (1 + 2) * c + 1                  # open rays' words x C, one test an occluded ray
    want = roofline.bound_ms(tests * 41, 1, 3, 2, 2 * 48 * c, 36, 1)
    assert roofline.anyhit_ms(words, counts, occ, tmax, c) == pytest.approx(want)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -3.0])
    assert reference.tf32_round(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0, -3.0]


def test_fit_numbers_and_judge():
    ref = {"losses": [1.0, 0.5, 0.25],
           "grad1": {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0]),
                     "c": torch.tensor([1e-9])},
           "change": {"a": torch.tensor([1.0, 0.0]), "b": torch.tensor([2.0]),
                      "c": torch.tensor([5.0])}}
    prog = {"losses": [1.02, 0.51, 0.25],
            "grad1": {"a": torch.tensor([3.0, 4.5]), "b": torch.tensor([1.0]),
                      "c": torch.tensor([0.0])},
            "change": {"a": torch.tensor([0.5, 0.0]), "b": torch.tensor([2.0]),
                       "c": torch.tensor([0.0])}}
    got = checks.fit_numbers(prog, ref)
    assert got["first_loss_gap"] == pytest.approx(0.02)
    # leaf a: |5.408 - 5| / max(5, the median leaf's 1)
    assert got["grad_gap"] == pytest.approx((float(torch.tensor([3.0, 4.5]).norm()) - 5) / 5)
    # change over a and b only (c's gradient is under a thousandth of the median)
    assert got["change_gap"] == pytest.approx(0.5 / 1.5)
    limits = {"first_loss_gap": 0.05, "grad_gap": 0.05, "change_gap": 0.2, "overflow": 0}
    ok, judged = checks.judge(dict(got, overflow=0), limits)
    assert not ok and judged["change_gap"]["limit"] == 0.2
    with pytest.raises(KeyError):
        checks.judge({}, {"overflow": 0})


def test_bad_pixel_share():
    ref = torch.zeros(4, 3)
    prog = torch.tensor([[0.0, 0, 0], [0.0021, 0, 0], [0, -0.003, 0], [0, 0, 0.0019]])
    assert checks.bad_pixel_share(prog, ref) == 0.5
