"""The benchmark's view of the engine's state, the one place that reads it.

The check follows the program step by step from its own state (see
``checks``): ``take`` copies, between two frames or around an update, what
a step reads and writes (the keyframes' timestamps, poses and patch
centres; the live edges with their hidden state, targets and weights; the
feature rings' rows of the frames asked for), and ``view`` puts a copy, or
the reference's state, into one form for the comparison.  The copies are
made on the engine's stream, with no wait.  Under loop closure ``take_lc``
adds the inactive edge store, at no cost: it only appends.
"""
from __future__ import annotations

import numpy as np
import torch

KEY = 1 << 20      # edge key kk * KEY + jj


def ring_features(slam, slot):
    """Frame ``slot``'s features as the rings hold them: fmap1, fmap2 (the
    interior of the zero-padded rings), gmap (M, P, P, 128), imap (M, DIM)."""
    ds, M = slam.ds, slam.M
    out = {}
    for name, h, w in (("fmap1", slam.ht // 4, slam.wd // 4),
                       ("fmap2", slam.ht // 16, slam.wd // 16)):
        ring = getattr(ds, name)
        pad = (ring.shape[1] - h) // 2
        out[name] = ring[slot % slam.mem, pad:pad + h, pad:pad + w].clone()
    rows = slice((slot % slam.pmem) * M, (slot % slam.pmem + 1) * M)
    out["gmap"] = ds.gmap[rows].clone()
    out["imap"] = ds.imap[rows].clone()
    return out


def take(slam, slots=None, features=(), net=True):
    """The engine's state; ``slots`` keyframe slots (default the live ones),
    the ring features of the slots ``features``, and with ``net`` the live
    edges' hidden state.  A patch is its centre: x, y, inverse depth."""
    ds, hs, M = slam.ds, slam.hs, slam.M
    n = hs.n if slots is None else slots
    e = hs.e_num
    P = ds.patches.shape[-1] // 2
    return dict(
        n=n, counter=hs.counter,
        tstamps=hs.tstamps[:n].astype(np.int64).copy(),
        ii=hs.ii[:e].astype(np.int64).copy(),
        jj=hs.jj[:e].astype(np.int64).copy(),
        kk=hs.kk[:e].astype(np.int64).copy(),
        poses=ds.poses[:n].clone(), patches=ds.patches[:n * M, :, P, P].clone(),
        net=ds.net[:e].clone() if net else None,
        target=ds.target[:e].clone(), weight=ds.weight[:e].clone(),
        features={int(hs.tstamps[s]): ring_features(slam, s)
                  for s in features})


def take_lc(slam, *a, **kw):
    """``take`` under loop closure, with ``inac``: the inactive edge store's
    row count ``n``, its host index arrays ``ii``, ``jj``, ``kk`` (the
    engine replaces them when it stores, never writes into them, so a
    reference is a copy), ``last_global_ba`` (the keyframe count of the last
    loop round with edges) and ``ran`` (whether global BA ran at this
    keyframe count).  The store's device rows [0, n) are written once, so
    the check slices them from the store as the run left it."""
    s = take(slam, *a, **kw)
    hs = slam.hs
    s["inac"] = dict(n=hs.n_inac, ii=hs.ii_inac, jj=hs.jj_inac,
                     kk=hs.kk_inac, last_global_ba=slam.last_global_ba,
                     ran=bool(slam.ran_global_ba[s["n"]]))
    return s


def edge_keys(ii, jj, kk):
    return np.asarray(kk, np.int64) * KEY + np.asarray(jj, np.int64)


def program_view(s):
    """A ``take`` copy in the comparison's form: edges sorted by key."""
    keys = edge_keys(s["ii"], s["jj"], s["kk"])
    order = np.argsort(keys, kind="stable")
    o = torch.as_tensor(order, device=s["net"].device)
    return dict(tstamps=s["tstamps"], keys=keys[order], net=s["net"][o],
                target=s["target"][o], weight=s["weight"][o],
                poses=s["poses"].float(), ctr=s["patches"][:, :2].float(),
                depth=s["patches"][:, 2].float(),
                features=s["features"])


def reference_view(st, num):
    """The reference's state after a step (``reference.engine``)."""
    keys = edge_keys(st.ii, st.jj, st.kk)
    order = np.argsort(keys, kind="stable")
    o = torch.as_tensor(order, device=num.device)
    return dict(tstamps=np.asarray(st.tstamps, np.int64), keys=keys[order],
                net=num.net[o], target=num.target[o], weight=num.weight[o],
                delta=num.delta[o], poses=num.poses, ctr=num.ctr,
                depth=num.depth, loose=num.loose, features=num.made)


def numeric_state(s, st):
    """The state ``reference.engine.Numeric`` starts a step from: the copy
    ``s`` with its edges in the order of the reference's ``st``."""
    keys = edge_keys(s["ii"], s["jj"], s["kk"])
    order = np.argsort(keys, kind="stable")
    pos = order[np.searchsorted(keys[order], edge_keys(st.ii, st.jj, st.kk))]
    o = torch.as_tensor(pos, device=s["net"].device)
    return dict(poses=s["poses"], ctr=s["patches"][:, :2],
                depth=s["patches"][:, 2], net=s["net"][o],
                target=s["target"][o], weight=s["weight"][o])
