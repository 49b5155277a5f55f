"""The check against its control and its faults: a run whose timed path
is the reference in bfloat16, or the program broken underneath, has to
come out not correct; the sound program correct. Tiny cells on the CPU,
the chip's look skipped; the control and the faults at the cells' own
size are ``gpubench/control.py``'s, on the card."""

import pytest
import torch

from gpubench import cell, control


@pytest.mark.parametrize("cell_name", ["tiny-sep.rl3", "tiny-fft.rl3"])
def test_sound_program_is_correct(run_tiny, cell_name):
    rc, _, _, result = run_tiny(cell_name, 2**33 + 1)
    assert rc == 0 and result["correct"] is True


@pytest.mark.parametrize("cell_name", ["tiny-sep.rl3", "tiny-fft.rl3"])
def test_control_in_bfloat16_is_not_correct(run_tiny, cell_name):
    rc, _, errs, result = run_tiny(cell_name, 2**33 + 2, make_step=cell.control_step)
    assert rc == 0 and result["correct"] is False
    check = result["check"]["max_rel_err"]
    assert check["value"] > 10 * check["limit"]


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("cell_name", ["tiny-sep.rl3", "tiny-fft.rl3"])
def test_faults_are_not_correct(run_tiny, cell_name, fault):
    rc, _, _, result = run_tiny(cell_name, 2**33 + 3, seconds=0.2,
                                make_step=control.FAULTS[fault])
    assert rc == 0 and result["correct"] is False and result["failed"] >= 1
    if fault in ("dim_voxel", "background_region"):  # the voxel's own scale catches these
        check = result["check"]["voxel_rel_err"]
        assert check["value"] > 10 * check["limit"]


@pytest.mark.parametrize("fault", ["dim_voxel", "background_region"])
def test_dim_faults_pass_under_the_brightest_voxels_scale(fault):
    """Where the brightest voxel is far above the background, as at the
    cells' own size, a dim fault stays under ``max_rel_err``'s limit and
    only ``voxel_rel_err`` sees it."""
    from gpubench import reference

    gen = torch.Generator().manual_seed(7)
    ref = 120.0 + torch.rand((8, 64, 64), generator=gen, dtype=torch.float64)
    ref.view(-1)[1000] = 2e5  # one bright blob's peak
    out = ref.float().clone()
    control._alter(fault, out)
    assert reference.max_rel_err(out, ref) < 1e-4 < reference.voxel_rel_err(out, ref)
    assert reference.voxel_rel_err(ref.float(), ref) < 1e-6


def test_raw_written_by_the_program_is_not_correct(run_tiny):
    def make(config, psf, device):
        step = cell.port_step(config, psf, device)

        def writes(batch, tf=None):
            out = step(batch, tf)
            batch[0, 0, 0, 0] += 1.0
            return out
        return writes
    result = run_tiny("tiny-sep.rl3", 5, make_step=make)[3]
    assert result["correct"] is False and result["check"]["raws_changed"]["value"] >= 1
