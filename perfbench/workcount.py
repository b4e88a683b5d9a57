"""The yardstick: the H100's published peaks, and the operations and bytes
the GNN's work needs, counted from its shapes alone (whatever implements
it).

The edge-stream counts are those the port's own kernel bounds have used
since the kernels were first timed, kept here unchanged so that no later
change to the program can move them:

- kernel 1 (edge-stream forward) reads t_proj, s_proj at their element
  size, edge_attr, W_e, gamma, beta, the target CSR (perm, src, offsets)
  once, writes the float32 sums once, and does (13 + 2*D) float32
  operations per edge channel, one more with dropout;
- kernel 2 (its backward) also reads the source CSR and g_out, writes
  d_t_proj, d_s_proj (at the stream's element size) and the (D+2, H)
  parameter gradients, and does (30 + 4*D) per edge channel, one more with
  dropout.

The step counts (:func:`train_step_work`, :func:`rollout_step_work`) split
a step into products, counted at the tensor rate of their dtype, and every
other float operation, at the float32 rate.
"""

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense, at 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12       # float32 outside the tensor cores (TF32 off)
PEAK_BF16_PER_S = 989e12     # bf16 tensor cores, float32 sums
EDGE_DIM = 5


def bound_s(n_bytes: float, flops: float) -> float:
    """Least seconds: the larger of the bytes over HBM bandwidth and the
    float32 operations over the float32 rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S)


def _csr_bytes(b: int, n: int, e: int) -> int:
    """int32 perm and src (E each) and offsets (N+1) of B graphs."""
    return 4 * b * (2 * e + n + 1)


def edge_fwd_s(b: int, n: int, e: int, h: int, stream_bytes: int,
               dropout: bool, d: int = EDGE_DIM) -> float:
    """Least seconds of one kernel-1 launch over B graphs of N nodes and E
    edges each; ``stream_bytes`` is 4 (float32) or 2 (bf16 stream)."""
    n_bytes = (2 * stream_bytes * b * n * h + 4 * b * e * d + 4 * d * h
               + 8 * h + _csr_bytes(b, n, e) + 4 * b * n * h)
    return bound_s(n_bytes, (13 + 2 * d + int(dropout)) * b * e * h)


def edge_bwd_s(b: int, n: int, e: int, h: int, stream_bytes: int,
               dropout: bool, d: int = EDGE_DIM) -> float:
    """Least seconds of one kernel-2 launch (no d_edge_attr)."""
    operands = (2 * stream_bytes * b * n * h + 4 * b * e * d + 4 * d * h
                + 8 * h + _csr_bytes(b, n, e))
    n_bytes = (operands + _csr_bytes(b, n, e)
               + b * n * h * (4 + 2 * stream_bytes) + 4 * (d + 2) * h)
    return bound_s(n_bytes, (30 + 4 * d + int(dropout)) * b * e * h)


@dataclass
class Work:
    """Floating-point operations of some work, by where they run."""

    mm_bf16: float = 0.0   # products on the bf16 tensor cores
    mm_f32: float = 0.0    # float32 products (TF32 off)
    other: float = 0.0     # every other float operation

    def __add__(self, o: "Work") -> "Work":
        return Work(self.mm_bf16 + o.mm_bf16, self.mm_f32 + o.mm_f32,
                    self.other + o.other)

    def __mul__(self, k: float) -> "Work":
        return Work(self.mm_bf16 * k, self.mm_f32 * k, self.other * k)

    def least_s(self) -> float:
        """Seconds at the published peaks, each kind at its own rate."""
        return (self.mm_bf16 / PEAK_BF16_PER_S + self.mm_f32 / PEAK_F32_PER_S
                + self.other / PEAK_F32_PER_S)


def _mm(flops: float, dtype: str) -> Work:
    return Work(mm_bf16=flops) if dtype == "bfloat16" else Work(mm_f32=flops)


def forward_work(b: int, n: int, k: int, h: int, n_layers: int,
                 node_in: int, out: int, dtype: str, dropout: bool) -> Work:
    """One forward of B graphs of N nodes with k edges a node: the products
    (encoder 2, per layer the two projections, the edge-output product and
    the node MLP's two, decoder 3; the last always float32), and the
    elementwise work: edge features 15 an edge, the edge stream's count of
    kernel 1, LayerNorm 8, SiLU 4, dropout 1 and residual 1 a node
    channel."""
    rows, e = b * n, n * k
    drop = int(dropout)
    w = _mm(2 * rows * node_in * h + 2 * rows * h * h, dtype)
    w += Work(other=rows * h * (8 + 4 + drop))           # encoder LN, SiLU
    w += Work(other=15 * b * e)                           # edge features
    per_layer = _mm(2 * rows * h * h * 2                  # projections
                    + 2 * rows * h * h                    # edge output
                    + 2 * rows * 2 * h * h + 2 * rows * h * h, dtype)
    per_layer += Work(other=(13 + 2 * EDGE_DIM + drop) * b * e * h
                      + rows * h * (2 + 8 + 4 + drop + 1 + 8))
    w += per_layer * n_layers
    w += _mm(2 * rows * h * h + 2 * rows * h * (h // 2), dtype)
    w += Work(mm_f32=2 * rows * (h // 2) * out)
    w += Work(other=rows * (h * (4 + drop) + (h // 2) * 4 + out))
    return w


def backward_work(b: int, n: int, k: int, h: int, n_layers: int,
                  node_in: int, out: int, dtype: str,
                  dropout: bool) -> Work:
    """The backward of :func:`forward_work`: every product twice (the
    gradients of its input and of its weight), the edge stream at kernel
    2's count, and twice the forward's other elementwise work."""
    fwd = forward_work(b, n, k, h, n_layers, node_in, out, dtype, dropout)
    e, drop = n * k, int(dropout)
    stream_f = (13 + 2 * EDGE_DIM + drop) * b * e * h * n_layers
    stream_b = (30 + 4 * EDGE_DIM + drop) * b * e * h * n_layers
    return Work(mm_bf16=2 * fwd.mm_bf16, mm_f32=2 * fwd.mm_f32,
                other=2 * (fwd.other - stream_f) + stream_b)


def train_step_work(b: int, n: int, k: int, h: int, n_layers: int,
                    node_in: int, out: int, n_params: int,
                    dtype: str) -> Work:
    """One training step: noise and normalisation (4 a state value), the
    forward and backward with dropout, the loss (30 a node), the global
    norm clip (4 a parameter) and AdamW (12 a parameter)."""
    return (Work(other=4 * b * n * 6 + 30 * b * n)
            + forward_work(b, n, k, h, n_layers, node_in, out, dtype, True)
            + backward_work(b, n, k, h, n_layers, node_in, out, dtype, True)
            + Work(other=16 * n_params))


def rollout_step_work(b: int, n: int, k: int, h: int, n_layers: int,
                      node_in: int, out: int) -> Work:
    """One float32 rollout step of B systems: normalisation (4 a state
    value), the k-NN (8 a pair of particles for the squared distance), the
    forward without dropout, de-normalisation (2 a state value)."""
    return (Work(other=6 * b * n * 6 + 8 * b * n * n)
            + forward_work(b, n, k, h, n_layers, node_in, out, "float32",
                           False))
