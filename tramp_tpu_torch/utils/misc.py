"""Small array helpers. Counterpart of tramp_tpu/utils/misc.py.

A complex array is packed as a real one with a leading axis of length 2
(real part, imaginary part), the layout of the modulus likelihood and the
complex channels; with lanes the packed axis comes after the lane axis
(axis 1). The complex channels keep their operators as complex tensors and
multiply a packed message through ``pair_matmul``, the counterpart of
tramp_tpu/ops/dft.py ``pair_matmul`` on torch's complex dtypes.

An operator split over a device mesh's model axis (``parallel.mesh``)
carries a ``ModelShard`` as its attribute ``model_shard``; ``pair_matmul``
and ``LinearChannel._mm``, the products every dense operator goes through,
then add the collectives that make the product the whole one."""
import torch
import torch.distributed as dist


class ModelShard:
    """An operator split on its last axis into ``size`` equal blocks over
    the ranks of ``group`` (the mesh's model axis), of which this rank holds
    block ``index``. Vectors stay whole on every rank, so with the local
    block ``A_p``:

    - ``A @ x`` (a contraction over the split axis) is ``A_p @ x_p``, with
      ``x_p`` this rank's block of ``x``, summed over the group;
    - ``A.T @ x`` (the split axis comes out) is this rank's block of the
      result, gathered over the group.

    A meta tensor (the shape sweeps) skips the collective and keeps the
    shape it would have."""

    def __init__(self, group, size, index):
        self.group, self.size, self.index = group, size, index

    def block(self, x, dim, width):
        "This rank's block of ``x`` along ``dim``, ``width`` long."
        return x.narrow(dim, self.index * width, width)

    def sum(self, partial):
        "The sum over the group of each rank's ``partial`` product."
        if not partial.is_meta:
            dist.all_reduce(partial, group=self.group)
        return partial

    def gather(self, block, dim):
        "The blocks of the group, in rank order, joined along ``dim``."
        if block.is_meta:
            return torch.cat([block] * self.size, dim)
        parts = [torch.empty_like(block) for _ in range(self.size)]
        dist.all_gather(parts, block.contiguous(), group=self.group)
        return torch.cat(parts, dim)

    def whole_shape(self, local):
        "The shape of the whole operator of the block ``local``."
        return tuple(local.shape[:-1]) + (local.shape[-1] * self.size,)


def model_shard(A):
    "The ``ModelShard`` of an operator split over the model axis, or None."
    return getattr(A, "model_shard", None)


def split_product(A, x, dim, transpose, product):
    """``product(A, x)`` (``A @ x`` or, with ``transpose``, ``A^T @ x``),
    made whole where ``A`` is split over the model axis; ``dim`` is the
    axis of ``x`` (and of the result) that meets ``A``'s last axis."""
    shard = model_shard(A)
    if shard is None:
        return product(A, x)
    if transpose:
        return shard.gather(product(A, x), dim)
    return shard.sum(product(A, shard.block(x, dim, A.shape[-1])))


def pack(c, axis=0):
    "A complex ``c`` packed with its re/im axis at ``axis``."
    return torch.stack([c.real, c.imag], dim=axis)


def unpack(z, axis=0):
    "The complex tensor of a packed ``z`` whose re/im axis is ``axis``."
    return torch.complex(z.select(axis, 0), z.select(axis, 1))


def complex2array(z):
    """Pack complex z into a real array Z with Z[0]=Re z, Z[1]=Im z.
    Reference tramp/utils/misc.py:13-19."""
    return pack(z)


def array2complex(Z):
    """Unpack real array Z (leading axis of length 2) into complex z.
    Reference tramp/utils/misc.py:22-27."""
    if Z.shape[0] != 2:
        raise ValueError("First axis of Z must be of length 2")
    return unpack(Z)


def pair_matmul(A, z, adjoint=False, axis=0):
    """``A @ z`` (``A^H @ z`` with ``adjoint``) for a complex matrix ``A``
    and a packed operand ``z``: one instance ``(2, m, ...)`` (axis 0), or
    lanes ``(B, 2, m)`` (axis 1) under one shared ``A`` (n, m) or one per
    lane ``(B, n, m)``. Returns the packed product. An ``A`` split over the
    model axis (``model_shard``) gives the whole product on every rank."""
    def product(A, c):
        if A.ndim == 3:
            M = A.conj().transpose(1, 2) if adjoint else A
            return torch.bmm(M, c.unsqueeze(-1)).squeeze(-1)
        if axis == 1:
            # (A^H c)^T = c^T conj(A), (A c)^T = c^T A^T
            return c @ (A.conj() if adjoint else A.T)
        return (A.conj().T if adjoint else A) @ c

    return pack(split_product(A, unpack(z, axis), axis, adjoint, product),
                axis)


def relu(x):
    return torch.clamp(x, min=0.0)


def leaky_relu(x, slope):
    return torch.where(x < 0, slope * x, x)


def hard_tanh(x):
    return torch.clamp(x, -1.0, 1.0)


def hard_sigm(x):
    return torch.clamp(0.5 + x / 6.0, 0.0, 1.0)


def symm_door(x, width):
    return torch.where(torch.abs(x) < width, -1.0, 1.0)
