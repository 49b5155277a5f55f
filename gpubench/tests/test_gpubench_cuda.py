"""On the card (skipped without one): a short run of each cell's
program at a tiny size with the CUDA kernels, correct, and the
control, not correct."""

import pytest

from gpubench import cell

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell_name", ["tiny-sep.rl3", "tiny-fft.rl3"])
def test_tiny_cell_on_the_card(cuda, tiny, cell_name):
    import io
    import json

    from gpubench import spec

    bench = spec.load_benchmark(tiny.parent / "BENCHMARK.json")
    for make_step, want in ((None, True), (cell.control_step, False)):
        out, err = io.StringIO(), io.StringIO()
        rc = cell.run(cell_name, 2**32 + 9, 0.5, False, device="cuda", make_step=make_step,
                      bench=bench, root=tiny, out=out, err=err)
        lines = out.getvalue().splitlines()
        assert rc == 0, err.getvalue()
        result = json.loads(lines[-1])
        assert result["correct"] is want and result["device"]["platform"] == "gpu"
        if make_step is None:
            counters = json.loads(lines[-2].split(": ", 1)[1])
            assert counters["plain_calls_on_cuda"] == {}
