"""The D^3 products of the sweeps split over a mesh's "bond" axis, with
explicit `torch.distributed` collectives.

Each rank owns one contiguous slice of the bond dimension (`BondSplit.sl`,
the columns its DTensor shards hold). A product runs the port's own einsum
function on the rank's slice of its operands, so each rank does 1/bond of
the D^3 work, and one collective assembles the result:

- `ac_apply` / `c_apply` (the Krylov matvecs): the rank's columns of the
  ket's right index and of GR, a partial sum over them, one all_reduce;
- `push_left` (a left environment push): the rank's columns of the new
  environment, one all_gather;
- `push_right`: a partial sum over the rank's columns of the old
  environment, one reduce_scatter to the rank's columns of the new one;
- `transfer_left_block` / `source_col_left` (the infinite environment
  walk): the rank's columns (rows) of the output, one all_gather.

The Krylov vectors, the QR / LQ panels and the small solves stay whole on
every rank. Every value that steers the host (a Ritz value, a residual, a
Krylov exit) is computed from these replicated tensors, which every
collective leaves identical on all ranks, so the ranks take the same
branches. A group of one rank still issues every collective.

`collectives` counts the collectives issued, as `utils.sync.count` counts
host reads; a run can reset it and read it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..algorithms import derivatives
from ..environments import infinite_ham
from ..transfermatrix.transfer import transfer_left_mpo, transfer_right_mpo

collectives = 0


def _laid_out_like(x, shape):
    """An empty tensor of `shape` whose dimensions lie in memory in the
    order of x's: a collective hands back its result in its operand's
    layout, so that a one-rank mesh reproduces the unsharded run bit for
    bit (the card's reductions sum in an order that depends on the
    strides)."""
    order = sorted(range(x.dim()), key=lambda i: x.stride(i), reverse=True)
    out = x.new_empty([shape[i] for i in order])
    return out.permute([order.index(i) for i in range(x.dim())])


def _real_view(x):
    """Collectives move float data: a complex tensor as its real view
    (a sum is linear, so the real and imaginary parts reduce apart)."""
    x = x.contiguous()
    return torch.view_as_real(x) if x.is_complex() else x


class MeshAxis:
    """The collectives over one named axis of a DeviceMesh: the process
    group of the ranks that share this rank's other coordinates."""

    def __init__(self, mesh, name: str):
        self.group = mesh.get_group(name)
        self.size = mesh.size(mesh.mesh_dim_names.index(name))
        self.rank = mesh.get_local_rank(name)

    def block(self, n: int, what: str = "items") -> range:
        """This rank's contiguous share of n items (a Shard placement's)."""
        if n % self.size:
            raise ValueError(f"{n} {what} do not divide over the mesh axis "
                             f"of size {self.size}")
        k = n // self.size
        return range(self.rank * k, (self.rank + 1) * k)

    def all_reduce(self, x):
        """The sum over ranks of x, in x's own memory layout (x is
        overwritten)."""
        global collectives
        collectives += 1
        y = _real_view(x)
        dist.all_reduce(y, group=self.group)
        if x.is_contiguous():
            return x
        return x.copy_(torch.view_as_complex(y) if x.is_complex() else y)

    def gather(self, x, dim: int):
        """All ranks' slices of dimension `dim`, concatenated in rank
        order."""
        global collectives
        collectives += 1
        xs = _real_view(x.movedim(dim, 0))
        buf = xs.new_empty((self.size * xs.shape[0],) + xs.shape[1:])
        dist.all_gather_into_tensor(buf, xs, group=self.group)
        if x.is_complex():
            buf = torch.view_as_complex(buf)
        shape = list(x.shape)
        shape[dim] *= self.size
        return _laid_out_like(x, shape).copy_(buf.movedim(0, dim))

    def reduce_scatter(self, x, dim: int):
        """The sum over ranks of x, this rank's slice of dimension
        `dim`."""
        global collectives
        collectives += 1
        xs = _real_view(x.movedim(dim, 0))
        buf = xs.new_empty((xs.shape[0] // self.size,) + xs.shape[1:])
        dist.reduce_scatter_tensor(buf, xs, group=self.group)
        if x.is_complex():
            buf = torch.view_as_complex(buf)
        shape = list(x.shape)
        shape[dim] //= self.size
        return _laid_out_like(x, shape).copy_(buf.movedim(0, dim))


class BondSplit(MeshAxis):
    """This rank's slice of the bond dimension D over the mesh's "bond"
    axis, and the D^3 products split over it."""

    def __init__(self, mesh, D: int):
        super().__init__(mesh, "bond")
        cols = self.block(D, "bond columns")
        self.width = len(cols)
        self.sl = slice(cols.start, cols.stop)

    def local(self, x):
        """This rank's columns of the last dimension of a whole tensor."""
        return x[..., self.sl]

    def ac_apply(self, GL, W, GR_loc, x):
        """derivatives.ac_apply with GR's columns this rank's: GL, W and x
        whole, the result whole."""
        return self.all_reduce(derivatives.ac_apply(GL, W, GR_loc,
                                                    x[..., self.sl]))

    def c_apply(self, GL, GR_loc, x):
        return self.all_reduce(derivatives.c_apply(GL, GR_loc,
                                                   x[..., self.sl]))

    def site_matvecs(self, GL, W, GR_loc):
        """The split site matvec and the first-restart probe that
        `ac_apply_fast` is in the unsharded sweep: kernel K1 for a float32
        tensor on the card, on GR gathered once per site when the probe
        runs; elsewhere the exact matvec."""
        def mv(x):
            return self.ac_apply(GL, W, GR_loc, x)

        if not (GL.is_cuda and GL.dtype == torch.float32):
            return mv, mv
        whole = []

        def fast(x):
            if not whole:
                whole.append(self.gather(GR_loc, -1).contiguous())
            return derivatives.ac_apply_fast(GL, W, whole[0], x)

        return mv, fast

    def push_left(self, GL, W, A):
        """transfer_left_mpo(GL, W, A, A), GL and A whole, the result
        whole."""
        return self.gather(transfer_left_mpo(GL, W, A[..., self.sl], A), -1)

    def push_right(self, GR_loc, W, A):
        """transfer_right_mpo(GR, W, A, A) with GR's columns this rank's
        and A whole; returns this rank's columns of the result."""
        return self.reduce_scatter(
            transfer_right_mpo(GR_loc, W, A[..., self.sl], A), -1)

    def transfer_left_block(self, v, Wab, A_ket, A_bra):
        return self.gather(infinite_ham.transfer_left_block(
            v, Wab, A_ket[..., self.sl], A_bra), -1)

    def source_col_left(self, G, Wcol, A):
        return self.gather(infinite_ham._source_col_left(
            G, Wcol, A, A_bra=A[..., self.sl]), -2)
