"""The plain references against tramp_tpu_torch in float64 on the CPU, at
small sizes: the same stop step and the same posteriors to rounding."""
import pytest
import torch

from portbench import inputs, manifest
from portbench.kinds.ep import judge, reference_kw

CELLS = ["cs_glm_f64.lanes2048", "relu_net_f64.lanes2048"]


def setting(workload, N, seed, lanes):
    cell = manifest.Cell(workload)
    config = dict(cell.config, N=N, M=N // 2, dtype="float64")
    solver = dict(config["solver"], **cell.cell.get("solver", {}))
    W = inputs.operator(config, seed, "cpu")
    ys = inputs.observations(config, W, inputs.generator("cpu", seed, 1),
                             lanes)
    return cell, config, solver, W, ys


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3, 2**40 + 7])
def test_reference_follows_the_port(workload, seed):
    from tramp_tpu_torch.parallel import dispatch_solver, with_buffers
    cell, config, solver, W, ys = setting(workload, 300, seed, 6)
    student, lik = cell.config_module.student(config, W, ys[0], "cpu")
    post, n_iter, conv = dispatch_solver(student, **solver).solve_info(
        with_buffers(student, {(lik, "y"): ys}))
    ref, stop, ref_conv = cell.reference.solve(config, W, ys,
                                               **reference_kw(solver))
    assert torch.equal(stop, n_iter) and torch.equal(ref_conv, conv)
    numbers = dict(judge(post, ref))
    assert numbers["r_gap"] < 1e-12 and numbers["v_gap"] < 1e-12


@pytest.mark.parametrize("workload", CELLS)
def test_a_lane_that_never_stops_is_read_at_max_iter(workload):
    cell, config, solver, W, ys = setting(workload, 200, 9, 3)
    kw = reference_kw(solver)
    short, stop, conv = cell.reference.solve(config, W, ys, **dict(
        kw, tol=0.0, max_iter=7))
    assert stop.tolist() == [7, 7, 7] and not bool(conv.any())
    assert all(bool(torch.isfinite(d["r"]).all()) for d in short.values())
    done, stop, conv = cell.reference.solve(config, W, ys, **kw)
    assert bool(conv.all()) and int(stop.min()) > 7
    assert not torch.equal(short["x"]["r"], done["x"]["r"])


def test_reference_svd_is_an_svd():
    from portbench.reference.plain import svd
    W = torch.randn(40, 90, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    U, s, V = svd(W, torch.float64)
    assert torch.allclose(U @ torch.diag(s) @ V.T, W, atol=1e-12)
    assert torch.allclose(V.T @ V, torch.eye(40, dtype=torch.float64),
                          atol=1e-12)


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (manifest.HERE / "configs").glob("*.json")))
def test_every_configuration_file_builds_and_its_control_runs(name):
    """Each file of configs/ (also the float32 ones that have no cell yet)
    names a builder and a reference that exist; at a small size the port
    builds it on the CPU and the reference runs in the precision below."""
    import importlib
    config = dict(manifest.read_json(manifest.HERE / "configs"
                                     / f"{name}.json"), N=120, M=60)
    assert config["name"] == name
    builder = importlib.import_module(
        f"portbench.configs.{config['builder']}")
    reference = importlib.import_module(
        f"portbench.reference.{config['reference']}")
    W = inputs.operator(config, 4, "cpu")
    ys = inputs.observations(config, W, inputs.generator("cpu", 4, 1), 2)
    student, lik = builder.student(config, W, ys[0], "cpu")
    assert student.factors[lik].y.shape == ys[0].shape
    post, stop, _ = reference.solve(config, W, ys, dtype=torch.float32,
                                    tf32=True, **reference_kw(dict(
                                        config["solver"], max_iter=5)))
    assert post["x"]["r"].dtype == torch.float32 and stop.tolist() == [5, 5]
