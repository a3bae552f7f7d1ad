"""The compressed-sensing GLM through the port: the student model and the
FLOPs of its dense products (``configs/cs_glm.json`` holds the sizes)."""


def student(config, W, y, device):
    """The observed model (prior @ LinearChannel(W) @ Gaussian likelihood)
    built by the port, which takes the SVD of W here; and the index of its
    likelihood among the model's factors, whose ``y`` each call replaces."""
    import tramp_tpu_torch as tt
    from tramp_tpu_torch.channels import GaussianChannel, LinearChannel
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    kw = dict(device=device, dtype=W.dtype)
    teacher = (
        GaussBernoulliPrior(size=config["N"], rho=config["rho"],
                            mean=config["prior_mean"],
                            var=config["prior_var"], **kw)
        @ tt.V(id="x") @ LinearChannel(W, name="W", **kw) @ tt.V(id="z")
        @ GaussianChannel(var=config["noise_var"]) @ tt.O(id="y")
    ).to_model()
    return teacher.to_observed({"y": y}), 2


def lane_iteration_flops(config):
    """FLOPs of the dense products of one loop iteration of one lane in
    SpectralVAMPSolver: V^T r2 and V (d - t), each 2 N k with k = M."""
    N, k = config["N"], min(config["N"], config["M"])
    return 2 * (2 * N * k)


def call_flops(config, lanes, iterations):
    """FLOPs of the dense products of one solve of ``lanes`` lanes whose
    loop ran ``iterations`` times (frozen lanes are computed too): U^T y
    before the loop, the loop, and the readout's V^T r2 and U (s d)."""
    N, M = config["N"], config["M"]
    k = min(N, M)
    per_lane = (2 * M * k + iterations * lane_iteration_flops(config)
                + 2 * N * k + 2 * M * k)
    return lanes * per_lane


def messages(config):
    "The piecewise-linear message kernels' shape per lane: none here."
    return None
