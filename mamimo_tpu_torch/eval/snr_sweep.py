"""SNR sweeps, their aggregation and plots (the port's copy of
``mamimo_tpu/eval/snr_sweep.py``).

Replaces the per-SNR MATLAB jobs and ``snr_loop_testing.m``: generate
(or take) a test set per SNR level, run the DNN and the closed loop,
aggregate means with 95% t-confidence intervals (``compute_CI``,
snr_loop_testing.m:112-116), and draw the four reference plots (BER /
EVM / MSE / beamforming gain against SNR).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mamimo_tpu_torch.config import SimConfig, TrainConfig
from mamimo_tpu_torch.eval.closed_loop import evaluate_closed_loop, nmse_vs_snr
from mamimo_tpu_torch.models.predictor import resolve_device
from mamimo_tpu_torch.pipeline.dataset import (
    CSIDataset,
    generate_dataset,
    scenario_generator,
)
from mamimo_tpu_torch.utils.seeds import seeded_generator


def compute_ci(x: np.ndarray, alpha: float = 0.05):
    """95% t-distribution confidence interval of the mean
    (snr_loop_testing.m:112-116)."""
    x = np.asarray(x, np.float64)
    n = len(x)
    sem = np.std(x, ddof=1) / np.sqrt(n) if n > 1 else 0.0
    try:
        from scipy import stats
        ts = stats.t.ppf([alpha / 2, 1 - alpha / 2], n - 1)
    except ImportError:
        ts = np.asarray([-1.96, 1.96])
    return (float(np.mean(x) + ts[0] * sem), float(np.mean(x) + ts[1] * sem))


@dataclasses.dataclass
class SweepResult:
    snr_levels: List[float]
    # metric[source][snr_index]
    nmse: Dict[str, List[float]]
    nmse_ci: Dict[str, List[tuple]]
    ber: Dict[str, List[float]]
    evm: Dict[str, List[float]]
    bf_gain: Dict[str, List[float]]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def run_snr_sweep(cfg: SimConfig, snr_levels: Sequence[float],
                  num_packets: int, seed: int = 0, predictor=None,
                  closed_loop: bool = False, max_cl_packets: int = 50,
                  with_mmse: bool = True, chunk: int = 16,
                  datasets: Optional[Dict[float, CSIDataset]] = None,
                  verbose: bool = True, scenario=None,
                  device=None) -> SweepResult:
    """Evaluate the estimators across an SNR sweep.

    Args:
      predictor: optional callable ds -> (B, C, Nt, Nr) complex DNN CSI.
      closed_loop: also run the (slow) BER/EVM/BF-gain loop.
      datasets: optional pre-generated {snr: dataset} (else generated
        here with the same experiment seed per level, the shared-scenario
        SNR loop of snr_loop.m).
      scenario: optional fixed user placement: pass the training
        scenario for the reference's shared-placement contract (its
        rng(67) fixes the placement across train and every test set,
        generate_maMIMO_LTF.m:43-51) while the packets still come from
        ``seed``.
      device: where it runs; None means the card (raises without one).
    """
    dev = resolve_device("cuda" if device is None else device)
    sources = ["ls"] + (["lmmse"] if with_mmse else []) + (
        ["dnn"] if predictor is not None else [])
    everyone = sources + ["perfect"]
    out = SweepResult(
        snr_levels=list(map(float, snr_levels)),
        nmse={s: [] for s in sources}, nmse_ci={s: [] for s in sources},
        ber={s: [] for s in everyone}, evm={s: [] for s in everyone},
        bf_gain={s: [] for s in everyone})
    for snr in snr_levels:
        if datasets is not None and snr in datasets:
            ds = datasets[snr]
        else:
            ds = generate_dataset(cfg, seed=seed, num_packets=num_packets,
                                  snr_db=snr, with_mmse=with_mmse,
                                  chunk=chunk, scenario=scenario, device=dev)
        preds = predictor(ds) if predictor is not None else None
        per_pkt = nmse_vs_snr(ds, preds, device=dev)
        for s in sources:
            if s not in per_pkt:
                # a given dataset without h_mmse: NaNs keep the series
                # aligned with snr_levels
                out.nmse[s].append(float("nan"))
                out.nmse_ci[s].append((float("nan"), float("nan")))
                continue
            out.nmse[s].append(float(np.mean(per_pkt[s])))
            out.nmse_ci[s].append(compute_ci(per_pkt[s]))
        if closed_loop:
            cl = evaluate_closed_loop(ds, predictions=preds,
                                      sources=tuple(everyone),
                                      max_packets=max_cl_packets, device=dev)
            for s in out.ber:
                m = cl.get(s)
                out.ber[s].append(float("nan") if m is None
                                  else float(np.mean(m.ber)))
                out.evm[s].append(float("nan") if m is None
                                  else float(np.mean(m.evm)))
                out.bf_gain[s].append(float("nan") if m is None
                                      else float(np.mean(m.bf_gain)))
        if verbose:
            print(f"[sweep] SNR {snr:+.0f} dB: " + "  ".join(
                f"{s} NMSE {10 * np.log10(out.nmse[s][-1] + 1e-30):.2f} dB"
                for s in sources))
    return out


def plot_sweep(result: SweepResult, outdir: str) -> bool:
    """The four reference plots (snr_loop_testing.m:67-107) as PNGs in
    outdir. Returns False, drawing nothing, where matplotlib is absent."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    os.makedirs(outdir, exist_ok=True)
    snr = result.snr_levels
    styles = {"ls": "-o", "lmmse": "-x", "dnn": "-*", "perfect": "-s"}
    labels = {"ls": "LS", "lmmse": "MMSE", "dnn": "Proposed",
              "perfect": "Perfect"}

    def plot(metric: Dict[str, list], name: str, ylabel: str, logy: bool):
        if not any(len(v) for v in metric.values()):
            return
        plt.figure()
        for s, vals in metric.items():
            if vals:
                (plt.semilogy if logy else plt.plot)(
                    snr, vals, styles.get(s, "-"), label=labels.get(s, s))
        plt.grid(True)
        plt.xlabel("SNR (dB)")
        plt.ylabel(ylabel)
        plt.legend()
        plt.savefig(os.path.join(outdir, name + ".png"))
        plt.close()

    plot(result.nmse, "MSE", "NMSE", logy=True)
    plot(result.ber, "BER", "Bit error rate (BER)", logy=True)
    plot(result.evm, "EVM", "EVM RMS (%)", logy=False)
    plot(result.bf_gain, "BeamformGain", "Beamforming gain (dB)", logy=False)
    return True


def mu_packet_generators(seed: int, p: int, num_users: int, device):
    """The generators of packet p of a multi-user sweep (JAX's
    ``fold_in(PRNGKey(seed), 10000 + p)``): each user's sounding, seeded
    from (seed, 10000 + p, 1000 + u), and the data leg's, from (seed,
    10000 + p, 77)."""
    return ([seeded_generator(device, seed, 10_000 + p, 1000 + u)
             for u in range(num_users)],
            seeded_generator(device, seed, 10_000 + p, 77))


def run_mu_snr_sweep(cfg: SimConfig, snr_levels: Sequence[float],
                     num_packets: int, seed: int = 0,
                     sources: Sequence[str] = ("ls", "perfect"),
                     fft_size: int = 16384, chunk: int = 8,
                     verbose: bool = True, dnn_models=None,
                     tcfg: Optional[TrainConfig] = None,
                     device=None) -> dict:
    """Multi-user closed-loop sweep (the numUsers > 1 branch,
    generate_maMIMO_LTF.m:427-440,531-640): per SNR level, sound
    ``num_packets`` packets to all users, JSDM-precode from each CSI
    source, decode every user, and aggregate per-(source, user)
    BER/EVM/BF gain with 95% CIs. A chunk of packets is one batch per
    user for the sounding and one batch per source for the data leg, whose
    draws a packet's sources share.

    JSDM's block diagonalization assumes spatially separable users: for
    nearly collinear placements the interference null eats the
    own-signal gain, so pick the seed (the placement) accordingly.

    Args (beyond the single-user sweep):
      dnn_models: the per-user DNN CSI source (the reference evaluates
        the DNN inside the beamforming loop, BER_test_maMIMO_LTF.m:347,
        with per-user models, generate_maMIMO_LTF.m:427-440): one
        (params, bn_state) per user, trained on generate_dataset(user=u).
        Required when 'dnn' is in sources.
      tcfg: the TrainConfig the models were trained with.
      device: where it runs; None means the card (raises without one).

    Returns a JSON-ready dict
      {"snr": [...], "num_users": U,
       "sources": {src: {"ber": [[per-user]...], "evm": ..,
                         "bf_gain": .., "ber_ci": ..}}}
    """
    from mamimo_tpu_torch.models.mlp import predict_all_pairs
    from mamimo_tpu_torch.pipeline.datatx import (
        data_tx_mu_from_draws,
        draw_data_tx_mu,
    )
    from mamimo_tpu_torch.pipeline.multiuser import (
        make_scenarios,
        sound_mu_from_draws,
    )
    from mamimo_tpu_torch.pipeline.sounding import draw_sounding
    from mamimo_tpu_torch.train.loop import _state_on
    from mamimo_tpu_torch.utils.numerics import full_f32_matmul

    if cfg.num_users < 2:
        raise ValueError("run_mu_snr_sweep needs num_users > 1")
    srcs = tuple(sources)
    if "dnn" in srcs and dnn_models is None:
        raise ValueError("the 'dnn' source needs dnn_models, one (params, "
                         "bn_state) per user")
    dev = resolve_device("cuda" if device is None else device)
    scens = make_scenarios(cfg, scenario_generator(seed, dev))
    models = None
    if "dnn" in srcs:
        models = [_state_on(p, b, dev) for p, b in dnn_models]
        tcfg = tcfg or TrainConfig()
    with_mmse = "lmmse" in srcs

    out = {"snr": list(map(float, snr_levels)), "num_users": cfg.num_users,
           "sources": {s: {"ber": [], "evm": [], "bf_gain": [],
                           "ber_ci": []} for s in srcs}}
    for snr in snr_levels:
        acc = {s: {"ber": [], "evm": [], "bf": []} for s in srcs}
        for start in range(0, num_packets, chunk):
            gens = [mu_packet_generators(seed, p, cfg.num_users, dev)
                    for p in range(start, min(start + chunk, num_packets))]
            res, chans = sound_mu_from_draws(
                cfg, scens,
                [draw_sounding(cfg, [g[0][u] for g in gens])
                 for u in range(cfg.num_users)],
                float(snr), with_mmse=with_mmse, fft_size=fft_size)
            pools = {"ls": res.h_ls, "perfect": res.h_perfect,
                     "lmmse": res.h_mmse}
            if models is not None:
                with torch.no_grad(), full_f32_matmul():
                    pools["dnn"] = torch.stack([
                        predict_all_pairs(cfg, tcfg, *models[u], res.rx[:, u])
                        for u in range(cfg.num_users)], dim=1)
            draws = draw_data_tx_mu(cfg, [g[1] for g in gens])
            for s in srcs:
                r = data_tx_mu_from_draws(cfg, scens, chans, pools[s],
                                          res.noise_db, res.snr_cs, draws,
                                          fft_size=fft_size)
                acc[s]["ber"].append(r.ber.cpu().numpy())        # (n, U)
                acc[s]["evm"].append(r.evm.cpu().numpy())
                acc[s]["bf"].append(r.bf_gain.cpu().numpy())
        for s in srcs:
            ber, evm, bf = (np.concatenate(acc[s][k])
                            for k in ("ber", "evm", "bf"))
            o = out["sources"][s]
            o["ber"].append(ber.mean(0).tolist())
            o["evm"].append(evm.mean(0).tolist())
            o["bf_gain"].append(bf.mean(0).tolist())
            o["ber_ci"].append([list(compute_ci(ber[:, u]))
                                for u in range(ber.shape[1])])
        if verbose:
            print(f"[mu-sweep] SNR {snr:+.0f} dB: " + "  ".join(
                f"{s} BER {np.mean(out['sources'][s]['ber'][-1]):.4f}"
                for s in srcs))
    return out
