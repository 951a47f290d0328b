"""Run artifacts: parameter manifest, pickled history, convergence plots.

Port of phylo_tpu/train/results.py (NumPy/pickle/JSON only).
Mirrors the reference's results layout (reference vcsmc.py:503-516,
595-644): a run directory
``<results_dir>/<dataset>/<nested>/<K>/<timestamp>/`` containing
run_parameters.txt, results.p, and Qmatrix/ELBO/ll PNGs -- plus a
machine-readable metrics.json the reference lacks.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import asdict
from datetime import datetime

import numpy as np


def make_save_dir(config, dataset):
    root = config.results_dir or "./results"
    tm = datetime.now().strftime("%Y-%m-%d-%H%M%S")
    path = os.path.join(
        root, dataset.name, str(config.nested), str(config.n_particles), tm
    )
    os.makedirs(path, exist_ok=True)
    return path


def write_run_params(save_dir, config, dataset):
    with open(os.path.join(save_dir, "run_parameters.txt"), "w") as f:
        f.write(f"dataset : {dataset.name} (N={dataset.N}, S={dataset.S}, "
                f"A={dataset.A})\n")
        for k, v in asdict(config).items():
            f.write(f"{k} : {v}\n")


def save_results(save_dir, config, dataset, history):
    """Pickle the training history with reference-compatible keys
    (reference vcsmc.py:622-642) plus extras, write metrics.json, and
    emit plots when matplotlib is available."""
    elbos = np.asarray(history["elbo"])
    ll_R = np.asarray(history["log_lik_R"])
    best_epoch = int(np.argmax(elbos)) if len(elbos) else 0

    result = {
        "cost": elbos,
        "nParticles": config.n_particles,
        "nTaxa": dataset.N,
        "lr": config.learning_rate,
        "log_weights": np.asarray(history["log_weights"]),
        "Qmatrices": np.asarray(history["Qmatrices"]),
        "left_branches": history["left_branches"],
        "right_branches": history["right_branches"],
        "log_lik": np.asarray(history["log_lik"]),
        "log_lik_R": ll_R,
        "stationary_probs": np.asarray(history["stationary"]),
        "rates_l": np.asarray(history["rates_l"]),
        "rates_r": np.asarray(history["rates_r"]),
        # full all-K per-epoch jump-chain history (reference
        # vcsmc.py:324,424-425,622-642); falls back to the best-particle
        # Newick per epoch when full collection was disabled
        "jump_chain_evolution": (
            history.get("jump_chain_evolution")
            or history.get("newick_best", [])
        ),
        "newick_best": history.get("newick_best", []),
        "best_epoch": best_epoch,
        "best_log_lik": ll_R[best_epoch] if len(ll_R) else None,
        "best_jump_chain": (
            history["jump_chain_evolution"][best_epoch]
            if history.get("jump_chain_evolution")
            and best_epoch < len(history["jump_chain_evolution"])
            else (
                history["newick_best"][best_epoch]
                if history.get("newick_best")
                else None
            )
        ),
        "epoch_seconds": history["epoch_seconds"],
        # final-epoch merge records (TPU-native replacement for string
        # jump chains): enough to rebuild every particle's tree
        "ancestors": (history.get("ancestors") or [None])[-1],
        "merged_nodes": (history.get("merged_nodes") or [None])[-1],
        "taxa": list(dataset.taxa),
    }
    with open(os.path.join(save_dir, "results.p"), "wb") as f:
        pickle.dump(result, f)

    with open(os.path.join(save_dir, "metrics.json"), "w") as f:
        json.dump(
            {
                "elbo": [float(e) for e in elbos],
                "best_epoch": best_epoch,
                "best_elbo": float(elbos.max()) if len(elbos) else None,
                "epoch_seconds": [
                    float(t) for t in history["epoch_seconds"]
                ],
            },
            f,
            indent=2,
        )

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return

    if len(history["Qmatrices"]):
        plt.figure()
        plt.imshow(history["Qmatrices"][-1])
        plt.title("Trained Q matrix")
        plt.colorbar()
        plt.savefig(os.path.join(save_dir, "Qmatrix.png"))
        plt.close()

    plt.figure(figsize=(10, 10))
    plt.plot(elbos)
    plt.ylabel("log $Z_{SMC}$")
    plt.xlabel("Epochs")
    plt.title("ELBO convergence across epochs")
    plt.savefig(os.path.join(save_dir, "ELBO.png"))
    plt.close()

    if len(ll_R):
        plt.figure(figsize=(10, 10))
        plt.plot(ll_R, c="black", alpha=0.2)
        plt.plot(ll_R.mean(axis=1), c="orange")
        plt.ylabel("log likelihood")
        plt.xlabel("Epochs")
        plt.title("Log likelihood convergence across epochs")
        plt.savefig(os.path.join(save_dir, "ll.png"))
        plt.close()
