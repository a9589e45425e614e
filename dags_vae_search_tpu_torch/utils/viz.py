"""DAG visualization (matplotlib).

Counterpart of ``dags_vae_search_tpu/utils/viz.py``: a layered DAG drawing
with arrow patches plus a three-panel generated / PACE-wrapped / decoded
demo.  Layout is longest-path layering with barycenter ordering, computed
from the adjacency in numpy.  matplotlib is imported inside the drawing
functions, so importing this module does not need it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def layered_layout(adj: np.ndarray) -> np.ndarray:
    """[N, 2] positions: y = longest-path layer, x = barycenter order."""
    adj = np.asarray(adj) > 0
    n = adj.shape[0]
    layer = np.zeros(n, dtype=int)
    for j in range(n):  # topological index order: parents precede children
        parents = np.flatnonzero(adj[:, j])
        if parents.size:
            layer[j] = layer[parents].max() + 1

    x = np.zeros(n)
    for lvl in sorted(set(layer.tolist())):
        nodes = np.flatnonzero(layer == lvl)
        bary = []
        for v in nodes:
            parents = np.flatnonzero(adj[:, v])
            bary.append(x[parents].mean() if parents.size else float(v))
        order = nodes[np.argsort(bary, kind="stable")]
        for rank, v in enumerate(order):
            x[v] = (rank + 0.5) / len(nodes)

    max_layer = max(layer.max(), 1)
    y = 1.0 - layer / max_layer
    return np.stack([x, y], axis=1)


def draw_dag(
    adj: np.ndarray,
    ax,
    labels: Optional[Sequence] = None,
    node_size: float = 0.035,
    node_color: str = "skyblue",
    edge_color: str = "k",
    arrowsize: float = 15,
    fontsize: int = 8,
) -> None:
    """Draw one DAG (adjacency matrix) on a matplotlib Axes."""
    import matplotlib.pyplot as plt
    from matplotlib.patches import FancyArrowPatch

    adj = np.asarray(adj)
    pos = layered_layout(adj)
    for a, b in zip(*np.nonzero(adj > 0)):
        ax.add_patch(FancyArrowPatch(
            tuple(pos[a]), tuple(pos[b]), arrowstyle="-|>", mutation_scale=arrowsize,
            color=edge_color, linewidth=1, zorder=1, shrinkA=8, shrinkB=8,
        ))
    for v in range(adj.shape[0]):
        ax.add_patch(plt.Circle(tuple(pos[v]), radius=node_size, facecolor=node_color,
                                edgecolor="k", zorder=2))
        text = str(labels[v]) if labels is not None else str(v)
        ax.text(pos[v, 0], pos[v, 1], text, fontsize=fontsize, ha="center", va="center",
                zorder=3)
    ax.set_xlim(-0.08, 1.08)
    ax.set_ylim(-0.08, 1.08)
    ax.set_aspect("equal")
    ax.axis("off")


def draw_examples(
    model,
    labels: np.ndarray,
    adj: np.ndarray,
    generator: Optional[torch.Generator] = None,
    out_path: Optional[str] = None,
    naming: Optional[dict] = None,
):
    """Three-panel demo of the first graph: original / PACE-wrapped /
    decoded reconstruction, on the model's device (``generator`` drives the
    decode's draws, as in ``decode_to_labeled``; seeded 0 when None).
    Returns ``out_path`` when it is given, else the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from dags_vae_search_tpu_torch.graphs.dag import pace_wrap
    from dags_vae_search_tpu_torch.models.decode import decode_to_labeled
    from dags_vae_search_tpu_torch.search.latent import encode_mu

    name = naming or {}

    def names(ls: np.ndarray) -> List[str]:
        return [str(name.get(int(v), int(v))) for v in ls]

    dev = next(model.parameters()).device
    labels, adj = np.asarray(labels), np.asarray(adj, dtype=np.float32)
    lb = torch.as_tensor(labels[None] if labels.ndim == 1 else labels[:1], device=dev)
    ad = torch.as_tensor(adj[None] if adj.ndim == 2 else adj[:1], device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    wrapped = pace_wrap(lb, ad)
    recon, valid = decode_to_labeled(model, encode_mu(model, lb, ad), generator)

    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(18, 5))
    fig.suptitle("DAG-VAE round trip")
    ax1.set_title("Original DAG")
    draw_dag(ad[0].cpu().numpy(), ax1, names(lb[0].cpu().numpy()))
    ax2.set_title("PACE wrapping")
    pace_names = ["Start", "Input"] + names(wrapped.labels[0].cpu().numpy()[2:-1] - 3) + ["Output"]
    draw_dag(wrapped.adj[0].cpu().numpy(), ax2, pace_names)
    ax3.set_title(f"Decoded DAG (valid={bool(valid[0])})")
    draw_dag(recon.adj[0].cpu().numpy(), ax3, names(recon.labels[0].cpu().numpy()))
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig
