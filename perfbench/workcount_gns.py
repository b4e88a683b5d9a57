"""The yardstick of GNS: the operations and bytes its training step and its
receiver sum need, counted from the shapes alone (whatever implements
them), at the H100's published peaks (:mod:`perfbench.workcount`: bf16
products at 989 TFLOP/s, float32 products and every other operation at 67,
bytes at 3.35 TB/s).

A step's products are counted in their least form: the edge MLP's first
Dense (3L -> H) as L -> H on the edges and two L -> H node projections
(its sender's and receiver's slices run on the nodes, then gathered).
Elementwise work: a LayerNorm 8 operations an element, a ReLU 1, a
residual 1, the two gathered projections added to the edge's 2, the
receiver sum 1 an edge element, the edge input 8 an edge; the backward
twice the forward's products and its other work.
"""

from perfbench.workcount import Work, _mm, bound_s

NODE_IN = 4
EDGE_IN = 4


def receiver_sum_s(b: int, n: int, e: int, f: int) -> float:
    """Least seconds of one receiver-sum launch over B graphs of N nodes
    and E edges, F features: every message read once, the CSR (perm and
    offsets) read once, the sums written once; one add a message
    element."""
    n_bytes = 4 * b * e * f + 4 * b * (e + n + 1) + 4 * b * n * f
    return bound_s(n_bytes, b * e * f)


def _mlp(rows: int, widths: list, dtype: str, norm: bool,
         last_f32: bool = False) -> Work:
    """An MLP over ``rows`` rows: its products (the last in float32 where
    ``last_f32``), a ReLU between products, LayerNorm where ``norm``."""
    w = Work()
    for i in range(len(widths) - 1):
        flops = 2 * rows * widths[i] * widths[i + 1]
        last = i == len(widths) - 2
        w += Work(mm_f32=flops) if (last and last_f32) else _mm(flops, dtype)
        if not last:
            w += Work(other=rows * widths[i + 1])
    if norm:
        w += Work(other=8 * rows * widths[-1])
    return w


def forward_work(b: int, n: int, k: int, latent: int, hidden: int,
                 n_hidden: int, steps: int, out: int, dtype: str) -> Work:
    """One forward of B graphs of N nodes with k edges a node."""
    rows, e = b * n, b * n * k
    mid = [hidden] * n_hidden
    w = Work(other=8 * e)
    w += _mlp(rows, [NODE_IN] + mid + [latent], dtype, True)
    w += _mlp(e, [EDGE_IN] + mid + [latent], dtype, True)
    per_step = _mm(2 * e * latent * hidden + 2 * rows * 2 * latent * hidden,
                   dtype)
    per_step += Work(other=2 * e * hidden)
    per_step += _mlp(e, mid + [latent], dtype, True) + Work(other=e * hidden)
    per_step += Work(other=e * latent)                       # receiver sum
    per_step += _mlp(rows, [2 * latent] + mid + [latent], dtype, True)
    per_step += Work(other=(e + rows) * latent)               # residuals
    w += per_step * steps
    w += _mlp(rows, [latent] + mid + [out], dtype, False, last_f32=True)
    w += Work(other=rows * out)
    return w


def train_step_work(b: int, n: int, k: int, latent: int, hidden: int,
                    n_hidden: int, steps: int, out: int, n_params: int,
                    dtype: str) -> Work:
    """One training step: noise and normalisation (4 a state value), the
    forward and its backward (twice the forward), the loss (30 a node),
    the global-norm clip (4 a parameter) and AdamW (12 a parameter)."""
    fwd = forward_work(b, n, k, latent, hidden, n_hidden, steps, out, dtype)
    return (Work(other=4 * b * n * 6 + 30 * b * n) + fwd + fwd * 2
            + Work(other=16 * n_params))


def cell_step_s(reading) -> float:
    """Least seconds of one training step of the reading's cell."""
    cfg = reading.cell.config
    mc = cfg["model_config"]
    return train_step_work(
        reading.cell.traffic["batch_size"], cfg["particles"],
        cfg["k_neighbors"], mc["latent_size"], mc["mlp_hidden_size"],
        mc["mlp_num_hidden_layers"], mc["num_message_passing_steps"],
        mc["output_dim"], reading.state["n_params"], mc["dtype"]).least_s()


def cell_receiver_sum_s(reading) -> float:
    """Least seconds of one receiver-sum launch of the reading's cell."""
    cfg = reading.cell.config
    b, n = reading.cell.traffic["batch_size"], cfg["particles"]
    return receiver_sum_s(b, n, n * cfg["k_neighbors"],
                          cfg["model_config"]["latent_size"])
