"""Render the continuation-branch diagram from the sweep checkpoints.

Produces artifacts/branch_diagram.png: two small multiples over the shared
beta axis — wave speed c(beta) and the leading eigenvalue of the
equation-free map (with the |lambda| = 1 stability threshold).  Single
series per panel (titles name them; no legend needed); the two sweep
precisions are distinguished by categorical slots 1 (fp32) and 2
(fp64 CPU), fixed order.
"""

import json
import pathlib

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

HERE = pathlib.Path(__file__).resolve().parent

SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT2 = "#52514e"
S1 = "#2a78d6"   # categorical slot 1: fp32 sweeps
S2 = "#eb6834"   # categorical slot 2: fp64 CPU sweep


def load(sweep):
    steps = []
    with open(HERE / sweep / "steps.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            d = np.load(HERE / sweep / f"step_{rec['index']:05d}.npz")
            ev = d["eigenvalues"]
            steps.append((rec["beta"], d["solution"][0],
                          np.abs(ev).max() if ev.size else np.nan))
    arr = np.array(steps)
    return arr[arr[:, 0].argsort()]


def main():
    up = load("sweep_beta13-23")
    down = load("sweep_beta13-down")
    low64 = load("sweep_beta8-down-fp64")
    up64 = load("sweep_beta13-up-fp64")
    fast64 = load("sweep_fastbranch-down-fp64")
    fp32 = np.vstack([down, up])
    slow64 = np.vstack([low64, up64])

    fig, (ax1, ax2) = plt.subplots(
        2, 1, figsize=(7.2, 5.4), sharex=True, facecolor=SURFACE,
        gridspec_kw={"hspace": 0.28})
    for ax in (ax1, ax2):
        ax.set_facecolor(SURFACE)
        ax.grid(True, color="#e7e6e2", linewidth=0.8, zorder=0)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
        for s in ("left", "bottom"):
            ax.spines[s].set_color("#d8d7d2")
        ax.tick_params(colors=TEXT2, labelsize=9)

    ax1.plot(fp32[:, 0], fp32[:, 1], color=S1, lw=2, zorder=3)
    ax1.plot(slow64[:, 0], slow64[:, 1], color=S2, lw=2, zorder=3)
    ax1.plot(fast64[:, 0], fast64[:, 1], color=S2, lw=2, zorder=3)
    ax1.set_title("Wave speed c along the 3-spike branch",
                  loc="left", fontsize=11, color=TEXT)
    ax1.set_ylabel("c", color=TEXT2, fontsize=10, rotation=0, labelpad=12)
    # direct labels (selective), text in ink — marks carry identity
    ax1.annotate("fp32 sweep", (fp32[len(fp32)//2, 0],
                                    fp32[len(fp32)//2, 1]),
                 xytext=(0, 10), textcoords="offset points",
                 color=TEXT2, fontsize=9)
    ax1.annotate("fp64 CPU oracle", (low64[len(low64)//2, 0],
                                     low64[len(low64)//2, 1]),
                 xytext=(0, -16), textcoords="offset points",
                 color=TEXT2, fontsize=9)
    ax1.annotate("branch end\n(oracle-confirmed)",
                 (fp32[-1, 0], fp32[-1, 1]), xytext=(-30, -30),
                 textcoords="offset points", color=TEXT2, fontsize=8)
    ax1.annotate("slow branch ends here (fp64);\nfp32 Newton jumps to the fast branch",
                 (16.0, 0.44), xytext=(-150, -6),
                 textcoords="offset points", color=TEXT2, fontsize=8)
    ax1.annotate("fast branch (fp64)", (fast64[len(fast64)//3, 0],
                                        fast64[len(fast64)//3, 1]),
                 xytext=(0, 8), textcoords="offset points",
                 color=TEXT2, fontsize=9)

    ax2.plot(fp32[:, 0], fp32[:, 2], color=S1, lw=2, zorder=3)
    ax2.plot(slow64[:, 0], slow64[:, 2], color=S2, lw=2, zorder=3)
    ax2.plot(fast64[:, 0], fast64[:, 2], color=S2, lw=2, zorder=3)
    ax2.axhline(1.0, color=TEXT2, lw=1, ls=(0, (4, 3)), zorder=2)
    ax2.annotate("|λ| = 1 (map stability threshold)", (3.4, 1.0),
                 xytext=(0, 5), textcoords="offset points",
                 color=TEXT2, fontsize=8)
    ax2.set_yscale("log")
    ax2.set_title("Leading eigenvalue of the equation-free map",
                  loc="left", fontsize=11, color=TEXT)
    ax2.set_ylabel("|λ|max", color=TEXT2, fontsize=10)
    ax2.set_xlabel("β (mean synaptic rate)", color=TEXT2, fontsize=10)

    fig.suptitle("Continuation of the 3-spike traveling wave "
                 "(N=512, T=5, equation-free map)",
                 x=0.125, ha="left", fontsize=12, color=TEXT, y=0.98)
    out = HERE / "branch_diagram.png"
    fig.savefig(out, dpi=160, bbox_inches="tight", facecolor=SURFACE)
    print("wrote", out)


if __name__ == "__main__":
    main()
