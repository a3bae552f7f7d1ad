"""The frozen counts against chip_smoke.py's, and the dense products'
FLOPs against the products the port's solvers make."""
import importlib.util
import math

import pytest
import torch

from portbench.tests.helpers import ROOT
from portbench import counts, inputs, manifest

PL_SPECS = {
    "relu": counts.RELU_SPECS,
    "h-tanh": ((1.0, math.inf, 1.0, 0.0), (-1.0, 1.0, 0.0, 1.0),
               (-math.inf, -1.0, -1.0, 0.0)),
    "door": ((1.0, math.inf, 1.0, 0.0), (-1.0, 1.0, -1.0, 0.0),
             (-math.inf, -1.0, 1.0, 0.0)),
}


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kernel", ["pl_posterior", "pl_forward_message",
                                    "pl_backward_message"])
@pytest.mark.parametrize("channel", sorted(PL_SPECS))
@pytest.mark.parametrize("n,lanes,dtype", [
    (2048, 1, torch.float32), (2048, 2048, torch.float32),
    (20000, 1024, torch.float64), (2**20 + 300, 1, torch.float64)])
def test_kernel_counts_are_chip_smokes(kernel, channel, n, lanes, dtype):
    smoke = chip_smoke()
    specs = PL_SPECS[channel]
    assert counts.REGION_OPS == smoke.REGION_OPS
    assert counts.ELEMENT_OPS == smoke.ELEMENT_OPS
    assert (counts.operations(kernel, specs, n)
            == smoke.operations(kernel, specs, n))
    name = str(dtype).split(".")[1]
    assert (counts.bound_ms(kernel, specs, n, name, lanes)
            == smoke.bound_ms(kernel, specs, n, dtype, lanes))


def test_relu_specs_are_the_ports():
    from tramp_tpu_torch.channels import ReluChannel
    assert ReluChannel().region_specs == counts.RELU_SPECS


@pytest.mark.parametrize("workload,lanes", [
    ("cs_glm_f64.lanes2048", 4), ("relu_net_f64.lanes2048", 4),
    ("relu_net_f64.single", 1)])
def test_product_flops_are_the_solvers(workload, lanes, monkeypatch):
    """Every product LinearChannel._mm makes in one solve, counted as 2 m n
    per column, equals the configuration's count for the lanes and the
    loop's iterations."""
    from tramp_tpu_torch.channels import LinearChannel
    from tramp_tpu_torch.parallel import dispatch_solver, with_buffers
    cell = manifest.Cell(workload)
    config = dict(cell.config, N=120, M=60, dtype="float64")
    made = []
    plain = LinearChannel._mm

    def counted(A, x, *, lanes, transpose=False, bf16=None):
        if x.device.type != "meta":
            rows, cols = A.shape[-2:]
            made.append(2 * rows * cols * (x.numel() // x.shape[-1]
                                           if lanes else 1))
        return plain(A, x, lanes=lanes, transpose=transpose, bf16=bf16)

    W = inputs.operator(config, 5, "cpu")
    ys = inputs.observations(config, W, inputs.generator("cpu", 5, 1),
                             lanes)
    student, lik = cell.config_module.student(config, W, ys[0], "cpu")
    solver = dispatch_solver(student, **config["solver"])
    monkeypatch.setattr(LinearChannel, "_mm", staticmethod(counted))
    y = ys if lanes > 1 else ys[0]
    _, n_iter, _ = solver.solve_info(with_buffers(student, {(lik, "y"): y}))
    iterations = int(n_iter.max())
    assert sum(made) == cell.config_module.call_flops(config, lanes,
                                                      iterations)
