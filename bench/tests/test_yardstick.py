"""The frozen work arithmetic equals the program's at the cells' shapes."""
import pytest

from repro_torch.analysis import roofline
from bench.harness import spec, yardstick

# (B, S, K, G, D, window): the train cell's B1-B3 calls, a windowed call,
# the tune cell's microbatches of 1, 2 and 4
SHAPES = [(1, 16384, 8, 7, 128, None), (4, 4096, 8, 6, 128, 4096),
          (8, 2048, 8, 7, 128, None), (4, 2048, 8, 7, 128, None),
          (2, 2048, 8, 7, 128, None)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", ["B1", "B2", "B3"])
def test_flash_work_and_bound(shape, kernel):
    B, S, K, G, D, w = shape
    ours = yardstick.flash_work(kernel, B, S, S, K, G, D, 2, True, w)
    theirs = roofline.flash_work(kernel, B, S, S, K, G, D, 2, True, w)
    assert tuple(ours) == tuple(theirs)
    assert yardstick.kernel_bound(ours) == roofline.kernel_bound(theirs)
    assert yardstick.visible_pairs(S, S, True, w) == \
        roofline.visible_pairs(S, S, True, w)


def test_peaks():
    assert yardstick.PEAK_FLOPS == roofline.PEAK_FLOPS == 989e12
    assert yardstick.PEAK_FP32_FLOPS == roofline.PEAK_FP32_FLOPS == 67e12
    assert yardstick.HBM_BW == roofline.HBM_BW == 3.35e12


@pytest.mark.parametrize("name", [c["name"] for c in
                                  spec.load_benchmark()["configs"]])
def test_active_params(name):
    """N_active: the program's count less the embedding."""
    from bench.harness import program
    cfg = spec.config(name)
    mcfg = program.model_config(cfg)
    shapes = program.leaf_shapes(mcfg)
    _, active = roofline.count_params(shapes, None)
    V, d = shapes["embed"]
    assert yardstick.active_params(cfg) == active - V * d


def test_busy_union():
    assert yardstick.busy_union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert yardstick.busy_union_ns([]) == 0
