# The port's pipeline schedule tables (flashy_tpu_torch.parallel.schedules,
# numpy only) held to the JAX package's: every table, statistic, helper
# and error text equal, over S in {2, 4}, M in {2, 4, 8}, v in {1, 2},
# train and forward, packed and overlap.
import itertools

import numpy as np
import pytest

import flashy_tpu.parallel.schedules as ref
from flashy_tpu.analysis.trace.dead_compute import \
    dead_compute_stats as ref_dead_compute
import flashy_tpu_torch.parallel.schedules as port

GRID = list(itertools.product((2, 4), (2, 4, 8), (1, 2), ("train", "forward"),
                              (False, True), (False, True)))


def _build(module, *args, **kwargs):
    """The schedule, or the error's type and text."""
    try:
        return module.build_1f1b_schedule(*args, **kwargs)
    except (ValueError, RuntimeError) as exc:
        return type(exc).__name__, str(exc)


@pytest.mark.parametrize("stages,micro,interleave,mode,packed,overlap", GRID,
                         ids=lambda value: str(value))
def test_tables_stats_and_errors_equal_the_references(stages, micro,
                                                      interleave, mode,
                                                      packed, overlap):
    args = (stages, micro, interleave, mode)
    kwargs = {"packed": packed, "overlap": overlap}
    got, want = _build(port, *args, **kwargs), _build(ref, *args, **kwargs)
    if isinstance(want, tuple):
        assert got == want
        return
    for field in ("mode", "num_stages", "num_micro", "interleave",
                  "num_ticks", "stash_depth", "brx_depth", "idle_ticks",
                  "packed", "hop_latency", "num_chunks", "lanes",
                  "bubble_frac", "idle_ticks_per_device"):
        assert getattr(got, field) == getattr(want, field), field
    assert sorted(got.tables) == sorted(want.tables)
    for name, table in want.tables.items():
        assert got.tables[name].dtype == table.dtype, name
        np.testing.assert_array_equal(got.tables[name], table, err_msg=name)
    shape = (micro, 12, 32)
    for size in (4, 2):
        assert got.stats(shape, size) == want.stats(shape, size)
        assert got.stash_bytes(shape, size) == want.stash_bytes(shape, size)
    assert got.stats() == want.stats()
    assert port.dead_compute_stats(got) == ref_dead_compute(want)
    assert port.schedule_stats(stages, micro, interleave, mode=mode,
                               packed=packed, overlap=overlap,
                               microbatch_shape=shape) \
        == ref.schedule_stats(stages, micro, interleave, mode=mode,
                              packed=packed, overlap=overlap,
                              microbatch_shape=shape)


HELPER_GRID = list(itertools.product((1, 2, 3, 4), (1, 2, 4, 6, 8), (1, 2, 3)))


@pytest.mark.parametrize("stages,micro,interleave", HELPER_GRID,
                         ids=lambda value: str(value))
def test_helpers_and_validation_equal_the_references(stages, micro,
                                                     interleave):
    assert port.ring_perms(stages) == ref.ring_perms(stages)
    assert port.bubble_fraction(stages, micro, interleave) == \
        ref.bubble_fraction(stages, micro, interleave)
    assert port.gpipe_bubble_fraction(stages, micro) == \
        ref.gpipe_bubble_fraction(stages, micro)
    shape = (2, micro, 8)
    assert port.microbatch_bytes(shape, 2) == ref.microbatch_bytes(shape, 2)
    assert port.gpipe_stash_bytes(stages, micro, shape) == \
        ref.gpipe_stash_bytes(stages, micro, shape)
    for overlap in (False, True):
        for fn in ("packed_ticks", "packed_bubble_fraction"):
            try:
                want = getattr(ref, fn)(stages, micro, interleave, overlap)
            except ValueError as exc:
                with pytest.raises(ValueError) as got:
                    getattr(port, fn)(stages, micro, interleave, overlap)
                assert str(got.value) == str(exc)
            else:
                assert getattr(port, fn)(stages, micro, interleave,
                                         overlap) == want
    if stages == 1:
        assert port.schedule_stats(1, micro, microbatch_shape=shape) == \
            ref.schedule_stats(1, micro, microbatch_shape=shape)
    for batch, schedule, mode, fill in itertools.product(
            (micro, 2 * micro, 7), ("gpipe", "1f1b", "packed_1f1b", "zb"),
            ("train", "forward"), (False, True)):
        args = (stages, micro, batch)
        kwargs = dict(interleave=interleave, require_fill=fill,
                      schedule=schedule, mode=mode)
        try:
            ref.validate_pipeline_args(*args, **kwargs)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                port.validate_pipeline_args(*args, **kwargs)
            assert str(got.value) == str(exc)
        else:
            port.validate_pipeline_args(*args, **kwargs)
    assert port.KNOWN_SCHEDULES == ref.KNOWN_SCHEDULES
    assert port.PACKED_FORWARD_ERROR == ref.PACKED_FORWARD_ERROR
