"""The two-layer relu net through the port: the student model, the FLOPs
of its dense products and the shape of its message kernels
(``configs/relu_net.json`` holds the sizes)."""
from ..counts import RELU_SPECS


def student(config, W, y, device):
    """The observed model (prior @ LinearChannel(W) @ ReluChannel @
    Gaussian likelihood) built by the port, which takes the SVD of W here;
    and the index of its likelihood among the model's factors, whose ``y``
    each call replaces."""
    import tramp_tpu_torch as tt
    from tramp_tpu_torch.channels import (
        GaussianChannel, LinearChannel, ReluChannel)
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    kw = dict(device=device, dtype=W.dtype)
    teacher = (
        GaussBernoulliPrior(size=config["N"], rho=config["rho"],
                            mean=config["prior_mean"],
                            var=config["prior_var"], **kw)
        @ tt.V(id="x") @ LinearChannel(W, name="W", **kw) @ tt.V(id="z")
        @ ReluChannel() @ tt.V(id="a")
        @ GaussianChannel(var=config["noise_var"]) @ tt.O(id="y")
    ).to_model()
    return teacher.to_observed({"y": y}), 3


def lane_iteration_flops(config):
    """FLOPs of the dense products of one sweep of one lane in
    MLVAMPSolver: V^T bz and V (m - tz / az) (2 N k each), U^T bx and
    U (s m) (2 M k each), k = min(N, M)."""
    N, M = config["N"], config["M"]
    k = min(N, M)
    return 2 * (2 * N * k) + 2 * (2 * M * k)


def call_flops(config, lanes, iterations):
    """FLOPs of the dense products of one solve of ``lanes`` lanes whose
    loop ran ``iterations`` times (frozen lanes are computed too; the
    readout and the set-up make no product)."""
    return lanes * iterations * lane_iteration_flops(config)


def messages(config):
    """(elements per lane, region specs) of the two message kernels, one
    launch each per sweep: the relu factor's messages live on z, M long."""
    return config["M"], RELU_SPECS
