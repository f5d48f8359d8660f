# `python -m flashy_tpu_torch.serve` (flashy_tpu_torch/serve/__main__.py,
# the port of the JAX package's serving demo) on the CPU at the demo's
# tiny sizes: the five ported legs pass their gates, the unported slo
# leg raises, and the Hopper kernel's leg refuses to run without the card.
import pytest


def test_demo_legs_pass_on_cpu():
    from flashy_tpu_torch.serve.__main__ import main
    assert main(["--device", "cpu", "--kernel", "gather", "--legs",
                 "batching,speculative,chunked,paged,ssd"]) == 0


def test_demo_model_draft_leg_passes_on_cpu():
    # a random draft model proposes noise: exact output, no floor
    from flashy_tpu_torch.serve.__main__ import main
    assert main(["--device", "cpu", "--legs", "speculative", "--draft",
                 "model", "--accept-floor", "0"]) == 0


def test_demo_slo_leg_raises_and_fused_needs_the_card():
    from flashy_tpu_torch.serve.__main__ import main
    with pytest.raises(NotImplementedError, match="item 9"):
        main(["--device", "cpu", "--legs", "slo"])
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--legs", "paged", "--kernel", "fused"])
