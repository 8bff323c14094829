"""The TMA preconditions that the tensor-core kernels' wrappers check
(``repro_torch.kernels.tma``): a tensor that a tensor map cannot read
raises ``ValueError`` naming the condition, before any launch."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.tma import check_tma, tma_violation  # noqa: E402


def test_aligned_inputs_pass():
    # q [B,S,H,D] contiguous, and the same seen through a transpose
    assert tma_violation((2, 64, 4, 128), (32768, 512, 128, 1), 1024, 2) \
        is None
    x = torch.zeros(2, 4, 64, 8, dtype=torch.bfloat16).transpose(1, 2)
    check_tma("q", x)
    # embed.T seen in its storage orientation, a size-1 dim with any stride
    check_tma("w", torch.zeros(151, 64, dtype=torch.bfloat16))
    assert tma_violation((1, 64, 8), (3, 8, 1), 512, 2) is None


@pytest.mark.parametrize("shape, strides, ptr, why", [
    ((64, 128), (128, 1), 1032, "16-byte-aligned base"),
    ((64, 100), (100, 1), 1024, "strides in 16-byte multiples"),
    ((4, 64, 6, 8), (3072, 48, 8, 1), 1024, None),         # 96 B, 16 B: fine
    ((4, 64, 3, 4), (768, 12, 4, 1), 1024, "strides in 16-byte multiples"),
    ((64, 128), (1, 64), 1024, "contiguous last dim"),
])
def test_each_violation_is_named(shape, strides, ptr, why):
    assert tma_violation(shape, strides, ptr, 2) == why


def test_check_raises_value_error_with_the_condition():
    base = torch.zeros(64 * 128 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte-aligned base"):
        check_tma("q", base[1:1 + 64 * 128].view(64, 128))
    with pytest.raises(ValueError, match="strides in 16-byte multiples"):
        check_tma("w_s", torch.zeros(64, 300, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous last dim"):
        check_tma("k", torch.zeros(128, 64, dtype=torch.bfloat16).T)
