"""The twin of tests/test_param_counts.py on repro_torch: each FULL config
against its published size (specs only — no tensors are
made), and the analytic count against the spec tree, with the JAX
test's tolerances."""
import pytest

pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

# published ballparks (B params); tolerance covers arch-detail ambiguity
EXPECTED = {
    "deepseek-67b": (67.4, 0.03),
    "qwen3-8b": (8.2, 0.05),
    "mistral-large-123b": (122.6, 0.03),
    "gemma2-2b": (2.6, 0.05),
    "granite-moe-3b-a800m": (3.4, 0.08),
    "dbrx-132b": (131.6, 0.03),
    "qwen2-vl-72b": (72.7, 0.03),
    "xlstm-350m": (0.48, 0.45),   # assigned dims give ~0.48B; see DESIGN.md
    "zamba2-1.2b": (1.2, 0.15),
    "musicgen-large": (2.4, 0.10),
}


def test_expected_covers_the_ported_archs():
    assert set(EXPECTED) == set(configs.ARCH_NAMES)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_full_config_param_count(arch):
    n = LM(configs.get_config(arch)).n_params() / 1e9
    want, tol = EXPECTED[arch]
    assert abs(n - want) / want <= tol, f"{arch}: {n:.2f}B vs {want}B"


# the analytic count leaves out xlstm's layers (as in the JAX test)
@pytest.mark.parametrize("arch", [
    a for a in configs.ARCH_NAMES
    if not {"mlstm", "slstm"} & set(configs.get_config(a).pattern)])
def test_analytic_matches_spec_tree_for_attn_archs(arch):
    cfg = configs.get_config(arch)
    analytic = configs.param_count(cfg)
    real = LM(cfg).n_params()
    assert abs(analytic - real) / real < 0.02
