"""Poisoning attack models (paper §VI: data and model poisoning) — the port
of ``repro/core/attacks.py``.  Data attacks corrupt a client's batch; model
attacks corrupt its update before it reaches the server.

  static    sign_flip / gaussian_update / scale_attack / label_flip /
            backdoor_trigger / feature_noise: oblivious to the defense.
  adaptive  alie / min_max / min_sum / gate_aware: optimisation-based
            attackers (Baruch et al. 2019; Shejwalkar & Houmansadr 2021)
            that read the honest updates' statistics (malicious clients
            collude and see every honest update) and, for ``gate_aware``
            and ``CrossRoundGateAware``, the defense's own config.

Layout: a round's updates live in one (K, N) fp32 buffer whose columns
follow the JAX package's flatten order (``tree.row_views`` gives the
leaves), so the JAX attacks' flatten and unflatten cost nothing here:
every model attack takes and returns that buffer.  Honest rows come back
unchanged.

Randomness: the attacks that draw noise (``gaussian_update``,
``feature_noise``) take standard-normal ``noise`` of the input's shape,
from ``draw_noise`` in a round, so a test can feed them the JAX package's
own draws.  The bisections of ``min_max`` / ``min_sum`` / ``gate_aware``
are Python loops of tensor ops that stay on the device: nothing reads a
value back to the host.

Protocol of the round engines (``core/fedfits.py``, ``core/async_engine.py``):
``data_attack(batch, malicious, noise) -> {field: tensor}`` and
``update_attack(updates, malicious, noise) -> updates``; a callable with
``draws_noise = True`` gets ``noise`` from the round's draws, else None.
A stateful attacker (``stateful = True``) is called as
``update_attack(updates, malicious, noise, carry) -> (updates, carry)``,
closes its carry with ``observe(carry, bad)`` after the gate, and puts
``metrics(carry)`` into the round's history.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def _per_row(malicious, like):
    """(K,) -> broadcastable against a (K, ...) tensor."""
    return malicious.reshape((-1,) + (1,) * (like.dim() - 1))


def draw_noise(shape, generator):
    """Standard-normal noise for ``gaussian_update`` / ``feature_noise``."""
    return torch.randn(shape, generator=generator, device=generator.device)


# ---------------------------------------------------------------- data ----
def label_flip(labels, n_classes, malicious, *, mode="shift"):
    """Flip the labels of malicious clients.  labels: (K, B); malicious:
    (K,) 0/1.  ``shift``: y -> (y + 1) % n_classes (the paper's attack);
    ``target``: every label -> class 0."""
    if mode == "shift":
        flipped = torch.remainder(labels + 1, n_classes)
    else:
        flipped = torch.zeros_like(labels)
    return torch.where(_per_row(malicious, labels) > 0, flipped, labels)


def stamp_trigger(x, *, patch=3, value=1.0, hw_axes=None):
    """Stamp the backdoor trigger onto a batch of inputs, layout-aware:
    a ``patch`` x ``patch`` corner on the (H, W) axes of an image batch
    (ndim >= 4, NHWC: axes (-3, -2)), else the first ``patch`` features
    set to ``value`` (tabular (B, D) or (K, B, D) batches).  ``hw_axes``
    pins the spatial axes.  Returns a new tensor."""
    out = x.clone()
    if hw_axes is None:
        if x.dim() < 4:
            out[..., :patch].fill_(value)
            return out
        hw_axes = (-3, -2)
    idx = [slice(None)] * x.dim()
    for ax in hw_axes:
        idx[ax % x.dim()] = slice(0, patch)
    out[tuple(idx)].fill_(value)       # a fill on the device, capture-safe
    return out


def backdoor_trigger(images, labels, malicious, *, target=0, patch=3,
                     hw_axes=None):
    """Stamp the trigger and relabel to ``target`` on the malicious
    clients' batches (backdoor / targeted poisoning)."""
    trig = stamp_trigger(images, patch=patch, hw_axes=hw_axes)
    return (torch.where(_per_row(malicious, images) > 0, trig, images),
            torch.where(_per_row(malicious, labels) > 0,
                        torch.full_like(labels, target), labels))


def feature_noise(x, malicious, sigma, noise):
    """Gaussian feature corruption: x + sigma * noise on malicious rows
    (``noise`` standard normal, x's shape)."""
    return torch.where(_per_row(malicious, x) > 0, x + sigma * noise, x)


# --------------------------------------------------------------- model ----
def sign_flip(updates, malicious, *, scale=1.0):
    """Byzantine sign flip: u -> -scale * u for malicious clients."""
    m = _per_row(malicious, updates).to(updates.dtype)
    return updates * (1.0 - m) + (-scale) * updates * m


def gaussian_update(updates, malicious, sigma, noise):
    """Replace malicious updates with sigma * noise (``noise`` standard
    normal, the updates' shape)."""
    m = _per_row(malicious, updates).to(updates.dtype)
    return updates * (1.0 - m) + (sigma * noise) * m


def scale_attack(updates, malicious, gamma):
    """Model-replacement scaling: u -> gamma * u (boosted poisoning)."""
    m = _per_row(malicious, updates).to(updates.dtype)
    return updates * (1.0 + (gamma - 1.0) * m)


# ---------------------------------------------- adaptive (optimisation) ----
def _honest_stats(flat, malicious):
    """Per-coordinate mean and std over the honest rows, the honest mask h
    and its count nh (at least 1)."""
    h = (1.0 - malicious).float()
    nh = torch.clamp(h.sum(), min=1.0)
    mu = (flat * h[:, None]).sum(0) / nh
    var = (h[:, None] * torch.square(flat - mu[None])).sum(0) / nh
    return mu, torch.sqrt(var), h, nh


def _replace_malicious(flat, malicious, crafted):
    return torch.where(malicious[:, None] > 0, crafted[None], flat)


def alie(updates, malicious, *, z=None):
    """A-Little-Is-Enough [Baruch et al. 2019]: every malicious client
    sends mu - z * sigma per coordinate, (mu, sigma) the honest statistics.
    Default z = Phi^-1((n - m - s) / (n - m)) with s = floor(n/2 + 1) - m,
    clipped to [0, 3]."""
    flat = updates.float()
    mu, sd, _, _ = _honest_stats(flat, malicious)
    if z is None:
        n = torch.full((), float(flat.shape[0]), dtype=torch.float32,
                       device=flat.device)
        m = malicious.float().sum()
        s = torch.floor(n / 2.0 + 1.0) - m
        phi = torch.clamp((n - m - s) / torch.clamp(n - m, min=1.0),
                          0.5, 1.0 - 1e-6)
        z = torch.clamp(torch.special.ndtri(phi), 0.0, 3.0)
    return _replace_malicious(flat, malicious, mu - z * sd)


def _dev_direction(dev, mu, sd):
    if dev == "unit":
        return -mu / torch.clamp(torch.linalg.vector_norm(mu), min=_EPS)
    if dev == "std":
        return -sd
    if dev == "sign":
        return -torch.sign(mu)
    raise ValueError(dev)


def _distance_gamma(flat, malicious, *, dev, mode, n_iters, gamma_init):
    """(gamma, mu, p) of ``_distance_attack``: the bisection's answer, the
    honest mean and the deviation direction."""
    mu, sd, h, _ = _honest_stats(flat, malicious)
    p = _dev_direction(dev, mu, sd)
    sq = torch.sum(flat * flat, dim=1)
    d = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T),
                    min=0.0)
    neg_inf = torch.full_like(h, float("-inf"))
    if mode == "max":
        budget = torch.max(d * (h[:, None] * h[None, :]))
    else:
        budget = torch.max(torch.where(h > 0, (d * h[None, :]).sum(1),
                                       neg_inf))
    diff = mu[None] - flat
    a = torch.sum(diff * diff, dim=1)              # ||mu - u_k||^2
    b = diff @ p
    c = torch.sum(p * p)

    g = torch.full((), gamma_init, dtype=torch.float32, device=flat.device)
    step = g / 2.0
    best = torch.zeros_like(g)
    for _ in range(n_iters):
        dist = a + 2.0 * g * b + g * g * c
        if mode == "max":
            ok = torch.max(torch.where(h > 0, dist, neg_inf)) <= budget
        else:
            ok = (dist * h).sum() <= budget
        best = torch.where(ok, torch.maximum(best, g), best)
        g = torch.where(ok, g + step, g - step)
        step = 0.5 * step
    return best, mu, p


def _distance_attack(updates, malicious, *, dev, mode, n_iters=25,
                     gamma_init=10.0):
    """Shared core of min_max / min_sum [Shejwalkar & Houmansadr 2021]: the
    malicious update is mu + gamma * p, p a deviation direction and gamma
    the largest value (by a fixed ``n_iters``-step bisection) that keeps
    the crafted update's distance profile inside the honest clients' own:

      min_max:  max_h ||m - u_h||^2 <= max_{h,h'} ||u_h - u_h'||^2
      min_sum:  sum_h ||m - u_h||^2 <= max_h sum_{h'} ||u_h - u_h'||^2

    gamma = 0 (the honest mean) when nothing larger is feasible."""
    flat = updates.float()
    gamma, mu, p = _distance_gamma(flat, malicious, dev=dev, mode=mode,
                                   n_iters=n_iters, gamma_init=gamma_init)
    return _replace_malicious(flat, malicious, mu + gamma * p)


def min_max(updates, malicious, *, dev="std", n_iters=25, gamma_init=10.0):
    """Min-max distance attack: see ``_distance_attack``."""
    return _distance_attack(updates, malicious, dev=dev, mode="max",
                            n_iters=n_iters, gamma_init=gamma_init)


def min_sum(updates, malicious, *, dev="std", n_iters=25, gamma_init=10.0):
    """Min-sum distance attack: see ``_distance_attack``."""
    return _distance_attack(updates, malicious, dev=dev, mode="sum",
                            n_iters=n_iters, gamma_init=gamma_init)


def _clip(x, lo, hi):
    """jnp.clip with tensor bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _take(s, i):
    """Row i of the (K, N) matrix s per column; i a 0-d or (N,) index."""
    return torch.gather(s, 0, i.long().expand(1, s.shape[1]))[0]


def _gate_aware_targets(flat, malicious, cfg, *, scale=100.0):
    """The poison corner v, the gate reference ref and the trim window
    (lo, hi) shared by ``gate_aware`` and ``CrossRoundGateAware``; and
    whether the aggregator trims.  Honest order statistics come from a
    sort with the malicious rows pushed to +inf (ascending) or -inf (the
    upper bound)."""
    _, _, h, nh = _honest_stats(flat, malicious)
    mu = (flat * h[:, None]).sum(0) / nh
    k = flat.shape[0]
    trims = cfg.aggregator != "fedavg"
    honest = h[:, None] > 0
    asc = torch.sort(torch.where(honest, flat, float("inf")), dim=0).values
    t = torch.floor(cfg.trim_frac * nh).to(torch.int64)
    lo = _take(asc, t)
    desc = torch.sort(torch.where(honest, flat, float("-inf")),
                      dim=0).values
    hi = _take(desc, k - 1 - t)
    nh_i = nh.to(torch.int64)
    ref = 0.5 * (_take(asc, (nh_i - 1) // 2) + _take(asc, nh_i // 2))
    if not trims:
        # the anticipated contaminated median: the m crafted values land
        # below every honest value where mu > 0 and above where mu < 0
        m_cnt = k - nh_i
        side = (mu > 0).to(torch.int64)
        zero = torch.zeros_like(nh_i)
        lo_r = _clip((k - 1) // 2 - m_cnt * side, zero, nh_i - 1)
        hi_r = _clip(k // 2 - m_cnt * side, zero, nh_i - 1)
        ref = 0.5 * (_take(asc, lo_r) + _take(asc, hi_r))
        lo = torch.full_like(lo, float("-inf"))
        hi = torch.full_like(hi, float("inf"))
    return _clip(-scale * mu, lo, hi), ref, lo, hi, trims


def _gate_blend(v, ref, target, n_iters):
    """The smallest blend w in [0, 1] (an ``n_iters``-step bisection) whose
    (1 - w) v + w ref has cosine >= ``target`` to ref; 0 if w = 0 clears
    it already (w = 1 always does)."""
    dev = v.device
    target = torch.full((), target, dtype=torch.float32, device=dev)
    rn = torch.sqrt(torch.sum(ref * ref))

    def cos_w(w):
        u = (1.0 - w) * v + w * ref
        un = torch.sqrt(torch.sum(u * u))
        return torch.sum(u * ref) / torch.clamp(un * rn, min=_EPS)

    lo_w = torch.zeros((), device=dev)
    hi_w = torch.ones((), device=dev)
    for _ in range(n_iters):
        mid = 0.5 * (lo_w + hi_w)
        ok = cos_w(mid) >= target
        lo_w, hi_w = torch.where(ok, lo_w, mid), torch.where(ok, mid, hi_w)
    return torch.where(cos_w(lo_w.new_zeros(())) >= target, 0.0, hi_w)


def gate_aware(updates, malicious, cfg, *, margin=0.1, scale=100.0,
               n_iters=20):
    """Defense-aware attacker for the Eq.-11 pipeline: reads
    ``cfg.aggregator``, ``cfg.cosine_outlier_thresh`` and ``cfg.trim_frac``
    and crafts a colluding update just inside the deployed defenses: the
    trim window's most adversarial corner (or ``-scale * mu`` against a
    plain mean), blended toward the anticipated gate reference by the
    smallest weight (an ``n_iters``-step bisection) whose cosine clears
    ``thresh + margin``, then clipped to the window (or, against the mean,
    rescaled to the boosted magnitude)."""
    flat = updates.float()
    mu = _honest_stats(flat, malicious)[0]
    v, ref, lo, hi, trims = _gate_aware_targets(flat, malicious, cfg,
                                                scale=scale)
    w = _gate_blend(v, ref, cfg.cosine_outlier_thresh + margin, n_iters)
    crafted = (1.0 - w) * v + w * ref
    if trims:
        crafted = _clip(crafted, lo, hi)
    else:
        # the gate sees direction only: restore the boosted magnitude
        cn = torch.sqrt(torch.sum(crafted * crafted))
        crafted = crafted * (scale * torch.sqrt(torch.sum(mu * mu))
                             / torch.clamp(cn, min=_EPS))
    return _replace_malicious(flat, malicious, crafted)


class CrossRoundGateAware:
    """Stateful cross-round attacker: it probes the gate instead of
    modelling it.  The carry holds a blend weight b and last round's gate
    outcome; each round b retreats toward the reference if any colluder
    was caught (b <- b + lr (1 - b)) and presses harder if not
    (b <- b (1 - lr)).  The crafted update is (1 - b) v + b ref with v and
    ref from ``_gate_aware_targets``, clipped to the trim window.

      init(K)                         -> carry (b0, zeros(K))
      __call__(upd, mal, noise, carry) -> (crafted, adapted b)
      observe(b, bad)                 -> next carry (b, bad)
      gather(carry, idx)              -> the cohort's view of an (M,) carry
      metrics(carry)                  -> {"attack_blend": b}, for the history
    """

    stateful = True

    def __init__(self, cfg, *, scale=100.0, lr=0.5, blend0=0.5):
        self.cfg = cfg
        self.scale = float(scale)
        self.lr = float(lr)
        self.blend0 = float(blend0)

    def init(self, n_clients, device=None):
        return (torch.full((), self.blend0, dtype=torch.float32,
                           device=device),
                torch.zeros(n_clients, device=device))

    def __call__(self, updates, malicious, noise, carry):
        blend, prev_gated = carry
        caught = (prev_gated * malicious).sum() > 0
        blend = torch.where(caught, blend + self.lr * (1.0 - blend),
                            blend * (1.0 - self.lr))
        flat = updates.float()
        v, ref, lo, hi, trims = _gate_aware_targets(flat, malicious,
                                                    self.cfg,
                                                    scale=self.scale)
        crafted = (1.0 - blend) * v + blend * ref
        if trims:
            crafted = _clip(crafted, lo, hi)
        return _replace_malicious(flat, malicious, crafted), blend

    def observe(self, blend, gated_mask):
        return (blend, gated_mask)

    @staticmethod
    def gather(carry, idx):
        blend, prev_gated = carry
        return (blend, prev_gated[idx.long()])

    @staticmethod
    def metrics(carry):
        return {"attack_blend": carry[0]}
