# `python -m flashy_tpu_torch.serve` (flashy_tpu_torch/serve/__main__.py,
# the port of the JAX package's serving demo) on the CPU at the demo's
# tiny sizes: every leg passes its gates (the slo leg's: no alert on the
# healthy run, every request attributable, tracing overhead bounded), and
# the Hopper kernel's leg refuses to run without the card.
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
    # the name dates from when the slo leg raised: it is ported now (it
    # runs below), and this checks that the fused kernel still needs the
    # card, alone and beside the slo leg
    from flashy_tpu_torch.serve.__main__ import main
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--legs", "paged,slo", "--kernel",
              "fused"])
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--legs", "paged", "--kernel", "fused"])


def test_demo_slo_leg_passes_on_cpu():
    # one intra-op thread: the tiny model's steps gain nothing from more,
    # and on a loaded host a pool of them waits on every op, which would
    # put the leg's latency gates at the mercy of the neighbours
    import torch
    from flashy_tpu_torch.serve.__main__ import main
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert main(["--device", "cpu", "--legs", "slo"]) == 0
    finally:
        torch.set_num_threads(threads)
