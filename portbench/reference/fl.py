"""Algorithm 1 of arXiv:2211.03363, plain: B trajectories of T rounds.

A trajectory b has its own stream of draws (`portbench.inputs.Draws`,
shared by the SNR points of one seed), its SNR and its initial weights;
all B share the data shards and the topology.  One round:

  local   E epochs of minibatch SGD at every client (the N = B·K clients
          of all trajectories stacked, each on its own shard);
  sync    phase 1 θ̃ = Ã·S + n₁, phase 2 θ̄ = B̃·θ̃ + n₂, broadcast θ_k = θ̄_c(k),
          consensus the mean of θ̄ over the clusters, on the parameters
          packed flat in sorted-key leaf order, the noise the draws'
          unit normals times the receivers' stds;
  eval    accuracy of the consensus on the first ``eval_samples`` test
          images.

A scenario whose channel evolves (``cluster-churn``) first steps the
channel process (random-waypoint mobility, Gauss-Markov fading, AR(1)
log-normal shadowing) and derives the round's gains, SNRs and outage
graph; every ``recluster_every`` rounds from round 0 it re-clusters on
them; each round rebuilds the powers and weights from the current gains
under the current plan.

Every matmul runs in float32 (the caller sets TF32 as it wants it; the
reference proper runs with it off).  Nothing of the simulator is
imported: the inputs come from `portbench.inputs`, the dB and channel
arithmetic from its frozen copy (`portbench.reference.xla`).
"""
from __future__ import annotations

import torch

from portbench.reference import offline, xla
from portbench.reference.models import APPLY, identity, nll
from portbench.reference.models import tf32 as tf32_round


def _leaves(tree: dict) -> list:
    return [tree[k][j] for k in sorted(tree) for j in sorted(tree[k])]


def _tree(like: dict, leaves) -> dict:
    it = iter(leaves)
    return {k: {j: next(it) for j in sorted(like[k])} for k in sorted(like)}


def noise_var(total_power: float, snr_db: float) -> float:
    return total_power / (10.0 ** (snr_db / 10.0))


class Reference:
    """The B trajectories ``(draws[b], snrs[b])`` of one configuration on
    the given data and geometry.  ``sweep``: set up as a Monte-Carlo
    sweep (heads elected as the sweep's traced setup elects them, the
    channel's first pathloss as its setup takes it) rather than lone
    runs.  ``tf32``: the lower-precision control, every matmul and
    convolution of the model and the round on TF32-rounded operands
    (`portbench.reference.models.tf32`)."""

    def __init__(self, cfg: dict, traffic: dict, data: dict, geometry,
                 draws: list, snrs: list, device, *, sweep: bool,
                 tf32: bool = False):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.rnd = tf32_round if tf32 else identity
        self.draws, self.snrs, self.sweep = draws, snrs, sweep
        self.apply = APPLY[cfg["model"]]
        self.xs, self.ys = data["xs"], data["ys"]
        E = cfg["eval_samples"]
        self.x_ev, self.y_ev = data["x_test"][:E], data["y_test"][:E]
        self.B, self.K = len(draws), cfg["clients"]
        self.C, self.P = cfg["clusters"], float(cfg["topology"]["total_power"])
        self.n_k = self.xs.shape[1]
        self.steps = max(cfg["local_epochs"] * (self.n_k // cfg["batch_size"]),
                         1)
        self.geometry = geometry
        tc = cfg["topology"]
        K = self.K
        self.gain = link_gain(cfg, geometry)
        self.snr = xla.xla_link_snr(*self.gain, self.P / K, tc["noise_var"])
        self.adj = ((xla.db10(self.snr, "eager") >= tc["outage_snr_db"])
                    & ~torch.eye(K, dtype=torch.bool, device=device))
        self.recluster_every = traffic.get("recluster_every", 0)
        self.channel = (None if traffic.get("channel") is None else
                        Channel(cfg, traffic, geometry, draws, device,
                                sweep=sweep))

    # -- the offline phase ------------------------------------------------
    def _static_plan(self, draws) -> dict:
        first = draws.kmeans_first(self.K)
        if self.sweep:
            return offline.cluster_plan(self.snr, self.adj, self.C, first,
                                        jitted=True, db_mode="folded")
        return offline.cluster_plan(self.snr, self.adj, self.C, first,
                                    jitted=False, db_mode="eager")

    # -- one round --------------------------------------------------------
    def _local(self, leaves: list, like: dict, idx: torch.Tensor):
        """``steps`` SGD steps at the N stacked clients; returns the new
        leaves and each client's mean loss over its steps."""
        lr = self.cfg["lr"]
        rows = torch.arange(self.K, device=self.device).repeat(self.B)[:, None]
        losses = []
        for s in range(self.steps):
            batch = idx[:, s]
            p = [x.detach().requires_grad_(True) for x in leaves]
            loss = nll(self.apply(_tree(like, p), self.xs[rows, batch],
                                  self.rnd), self.ys[rows, batch])
            grads = torch.autograd.grad(loss.sum(), p)
            with torch.no_grad():
                leaves = [x - lr * g for x, g in zip(leaves, grads)]
            losses.append(loss.detach())
        return leaves, torch.stack(losses, dim=1).mean(dim=1)

    def _sync(self, leaves: list, plans: list, syncs: list, t: int):
        B, K = self.B, self.K
        flat = torch.cat([x.reshape(B, K, -1) for x in leaves], dim=2)
        d = flat.shape[2]
        new, cons = [], []
        for b in range(B):
            s = flat[b]
            mean_sq = sum(torch.sum(torch.square(x.reshape(B, K, -1)[b]),
                                    dim=1) for x in leaves) / d
            A, std1, Bm, kappa, M = offline.round_weights(
                plans[b], syncs[b], self.P, mean_sq)
            u1, u2 = self.draws[b].phase_noise(t, self.C, d)
            r = self.rnd
            theta_tilde = r(A) @ r(s) + std1[:, None] * u1
            theta_bar = r(Bm) @ r(theta_tilde) + kappa[:, None] * u2
            new.append(r(M) @ r(theta_bar))
            cons.append(theta_bar.mean(dim=0))
        new = torch.stack(new)
        cons = torch.stack(cons)
        out, cons_leaves, off = [], [], 0
        for x in leaves:
            n = x[0].numel()
            out.append(new[:, :, off:off + n].reshape(x.shape))
            cons_leaves.append(cons[:, off:off + n].reshape((B,) + x.shape[1:]))
            off += n
        return out, cons_leaves

    def _evaluate(self, like: dict, cons_leaves: list) -> torch.Tensor:
        acc = []
        for b in range(self.B):
            params = _tree(like, [x[b:b + 1] for x in cons_leaves])
            hits = 0.0
            for i in range(0, self.x_ev.shape[0], 1024):
                lp = self.apply(params, self.x_ev[None, i:i + 1024],
                                self.rnd)
                hits = hits + (torch.argmax(lp[0], dim=-1)
                               == self.y_ev[i:i + 1024]).sum()
            acc.append(hits / self.x_ev.shape[0])
        return torch.stack(acc)

    def run(self, rounds: int) -> dict:
        """Every trajectory's per-round loss and accuracy (B, rounds), its
        final consensus leaves, its initial ones and, under a scenario
        whose channel evolves, its heads in each round (B, rounds, C)."""
        B, K, dev = self.B, self.K, self.device
        init = [d.init_params() for d in self.draws]
        like = init[0]
        cons0 = [torch.stack(c) for c in zip(*(_leaves(p) for p in init))]
        leaves = [x[:, None].expand((B, K) + x.shape[1:])
                  .reshape((B * K,) + x.shape[1:]).clone() for x in cons0]
        nvs = [noise_var(self.P, s) for s in self.snrs]
        plans = [self._static_plan(d) for d in self.draws]
        syncs = [offline.sync_state(p, *self.gain, self.P, nv)
                 for p, nv in zip(plans, nvs)]
        chan = self.channel.init() if self.channel is not None else None
        losses, accs, heads = [], [], []
        cons = cons0
        for t in range(rounds):
            idx = torch.cat([d.batch_indices(t, K, self.steps,
                                             self.cfg["batch_size"], self.n_k)
                             for d in self.draws])
            leaves, client_loss = self._local(leaves, like, idx)
            if chan is not None:
                chan, view = self.channel.step(chan, t)
                if self.recluster_every and t % self.recluster_every == 0:
                    for b, dr in enumerate(self.draws):
                        plans[b] = offline.cluster_plan(
                            view["snr"][b], view["adj"][b], self.C,
                            dr.recluster_first(t, K), jitted=True,
                            db_mode="jit")
                syncs = [offline.sync_state(
                    plans[b], view["g_re"][b], view["g_im"][b], self.P,
                    torch.full((), nvs[b], dtype=torch.float32, device=dev))
                    for b in range(B)]
                heads.append(torch.stack([p["heads"] for p in plans]))
            with torch.no_grad():
                leaves, cons = self._sync(leaves, plans, syncs, t)
                accs.append(self._evaluate(like, cons))
            losses.append(client_loss.reshape(B, K).mean(dim=1))
        out = {"loss": torch.stack(losses, dim=1),
               "acc": torch.stack(accs, dim=1),
               "final": [_tree(like, [x[b] for x in cons]) for b in range(B)],
               "init": [_tree(like, [x[b] for x in cons0]) for b in range(B)]}
        if heads:
            out["heads"] = torch.stack(heads, dim=1)
        return out


def link_gain(cfg: dict, geometry):
    """(K, K) complex gains (real, imaginary) of the drawn geometry: the
    fading times the amplitude pathloss, zero on the diagonal, as the
    program's topology is built from the same draws."""
    tc, K = cfg["topology"], cfg["clients"]
    dev = geometry.positions.device
    amp = xla.xla_pathloss(geometry.positions, tc["d0"],
                           -tc["pathloss_exp"] / 2.0, "eager")
    off = 1.0 - torch.eye(K, device=dev)
    g_re = amp * geometry.h_re - 0.0 * geometry.h_im
    g_im = amp * geometry.h_im + 0.0 * geometry.h_re
    return off * g_re - g_im * 0.0, off * g_im + g_re * 0.0


class Channel:
    """The channel process of B trajectories: state (positions, waypoints,
    fading, shadowing) started at the drawn topology, stepped and viewed
    each round from the trajectories' draws."""

    def __init__(self, cfg: dict, traffic: dict, geometry, draws: list,
                 device, *, sweep: bool):
        sc, tc = traffic["channel"], cfg["topology"]
        self.cfg, self.geometry, self.draws = cfg, geometry, draws
        self.device, self.sweep, self.K = device, sweep, cfg["clients"]
        self.consts = xla.channel_constants(
            speed=sc["speed"], fading_rho=sc["fading_rho"],
            shadowing_rho=sc["shadowing_rho"],
            shadowing_std_db=sc["shadowing_std_db"],
            area_size=tc["area_size"], d0=tc["d0"],
            pathloss_exp=tc["pathloss_exp"],
            p_ref=float(tc["total_power"]) / self.K,
            noise_var=tc["noise_var"], outage_snr_db=tc["outage_snr_db"])

    def init(self) -> dict:
        """The first state: the fading recovered from the gains by the
        pathloss (taken eagerly in a lone run, as a traced setup takes it
        in a sweep), the first waypoints, no shadowing."""
        tc, K, B = self.cfg["topology"], self.K, len(self.draws)
        pl = xla.xla_pathloss(self.geometry.positions, tc["d0"],
                              -tc["pathloss_exp"] / 2.0,
                              "jit" if self.sweep else "eager")
        g_re, g_im = link_gain(self.cfg, self.geometry)
        eye = torch.eye(K, dtype=torch.bool, device=self.device)
        h_re = torch.where(eye, 0.0, g_re / pl)
        h_im = torch.where(eye, 0.0, g_im / pl)
        way = torch.stack([d.channel_init(K) for d in self.draws])
        return {"pos": self.geometry.positions.expand(B, K, 2).clone(),
                "way": way * tc["area_size"],
                "h_re": h_re.expand(B, K, K).clone(),
                "h_im": h_im.expand(B, K, K).clone(),
                "shadow": torch.zeros(B, K, K, device=self.device)}

    def arrived(self, state: dict) -> torch.Tensor:
        """(B, K) clients that reach their waypoint in the next step."""
        t = state["way"] - state["pos"]
        dist = xla.sqrt_f32(xla._fma_f32(t[..., 1], t[..., 1],
                                         t[..., 0] * t[..., 0]) + 1e-12)
        return dist <= self.consts["speed"]

    def step(self, state: dict, t: int):
        """Round ``t``'s step and its view (gains, SNRs, outage graph)."""
        c = self.consts
        drawn = [d.channel_step(t, self.K) for d in self.draws]
        fade_re, fade_im, shadow_n, way_u = (torch.stack(x)
                                             for x in zip(*drawn))
        pos, way, h_re, h_im, sh = xla.xla_channel_step(
            state["pos"], state["way"], state["h_re"], state["h_im"],
            state["shadow"], fade_re, fade_im, shadow_n, way_u, c)
        g_re, g_im, snr, adj = xla.xla_channel_view(pos, h_re, h_im, sh, c)
        return ({"pos": pos, "way": way, "h_re": h_re, "h_im": h_im,
                 "shadow": sh},
                {"g_re": g_re, "g_im": g_im, "snr": snr, "adj": adj})


def arrivals(cfg: dict, traffic: dict, geometry, draws: list,
             rounds: int, device) -> list:
    """The clients, over all trajectories, that reach their waypoint in
    each round of a sweep's channel process (the waypoint uniforms a
    round's step really reads), from the same draws as the run."""
    chan = Channel(cfg, traffic, geometry, draws, device, sweep=True)
    state, counts = chan.init(), []
    for t in range(rounds):
        counts.append(int(chan.arrived(state).sum()))
        state, _ = chan.step(state, t)
    return counts
