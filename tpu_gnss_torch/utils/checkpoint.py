# Copied from tpu_gnss/utils/checkpoint.py:1-126; load_state reads each
# npz member once and builds the port's ChannelState on an explicit
# device.
"""Receiver state checkpoint / resume.

The reference has no persistence at all — ephemerides live in RAM and die
with the process.  Here pipeline state between stages is plain
arrays/dataclasses, so saving it is one npz: acquisition results, decoded
ephemerides, the almanac store and tracking channel state can be stored
and restored, letting a receiver warm-start (skip cold search / re-decode)
across runs.  The npz keys are the reference's, so a file written by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..nav.almanac import Almanac
from ..nav.ephemeris import Ephemeris
from ..track.channel import _BOOL_FIELDS, ChannelState, init_state
from .metrics import METRICS


_EPH_FIELDS = [f.name for f in dataclasses.fields(Ephemeris)
               if f.name not in ("alpha", "beta")]


def _np_scalar(o):
    """JSON fallback: detections/meta may carry numpy scalars."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def save_state(path: str, *, ephemerides: Optional[dict] = None,
               channel_state: Optional[ChannelState] = None,
               detections: Optional[list] = None,
               almanac: Optional[dict] = None,
               meta: Optional[dict] = None) -> None:
    """Save receiver state to an ``.npz``.

    Args:
      ephemerides: {prn: Ephemeris}
      channel_state: batched tracking state (tensors on any device)
      detections: acquisition detection records (list of dicts)
      almanac: {prn: nav.almanac.Almanac} — with a last fix + time in
        ``meta`` this is what directs the next session's cold search
      meta: any JSON-serializable extras (fs, config hash, timestamps...)
    """
    payload: dict = {}
    if almanac:
        aprns = sorted(almanac)
        payload["alm_prns"] = np.asarray(aprns, np.int32)
        for f in dataclasses.fields(Almanac):
            if f.name != "prn":
                payload[f"alm_{f.name}"] = np.asarray(
                    [getattr(almanac[p], f.name) for p in aprns],
                    np.float64)
    if ephemerides:
        prns = sorted(ephemerides)
        payload["eph_prns"] = np.asarray(prns, np.int32)
        for name in _EPH_FIELDS:
            payload[f"eph_{name}"] = np.asarray(
                [getattr(ephemerides[p], name) for p in prns], np.float64)
        payload["eph_alpha"] = np.asarray(
            [ephemerides[p].alpha for p in prns], np.float64)
        payload["eph_beta"] = np.asarray(
            [ephemerides[p].beta for p in prns], np.float64)
    if channel_state is not None:
        for name, arr in channel_state._asdict().items():
            payload[f"chan_{name}"] = arr.detach().cpu().numpy()
    if detections is not None:
        payload["detections_json"] = np.frombuffer(
            json.dumps(detections, default=_np_scalar).encode(),
            dtype=np.uint8)
    if meta is not None:
        payload["meta_json"] = np.frombuffer(
            json.dumps(meta, default=_np_scalar).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def _read_npz(path: str) -> dict:
    """``{key: array}`` of every member of the ``.npz`` at ``path``, as
    ``np.load(path, allow_pickle=False)[key]`` gives it, each member read
    once through numpy's reader (an object-dtype member raises
    ``ValueError``) and counted in ``checkpoint.member_reads``; the file
    is closed before it returns."""
    arrays = {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            arrays[k] = z[k]
            METRICS.add("checkpoint.member_reads")
    return arrays


def load_state(path: str, *, device="cuda") -> dict:
    """Load a checkpoint; returns dict with the same keys save_state took.

    Each member is read once (:func:`_read_npz`), and the records are
    built from whole columns.  ``chan_*`` arrays become the port's ChannelState on
    ``device``; the device is touched only when the file holds channel
    state.
    """
    z = _read_npz(path)
    out: dict = {}
    if "eph_prns" in z:
        # field added after this checkpoint: absent here, its default kept
        cols = {name: z[f"eph_{name}"].astype(np.float64).tolist()
                for name in _EPH_FIELDS if f"eph_{name}" in z}
        alpha, beta = list(z["eph_alpha"]), list(z["eph_beta"])
        ephs = {}
        for i, prn in enumerate(z["eph_prns"].tolist()):
            e = Ephemeris()
            for name, col in cols.items():
                v = col[i]
                setattr(e, name, bool(v) if name == "has_utc"
                        else int(v) if name == "tow" else v)
            e.alpha, e.beta = tuple(alpha[i]), tuple(beta[i])
            ephs[int(prn)] = e
        out["ephemerides"] = ephs
    if "alm_prns" in z:
        cols = {f.name: z[f"alm_{f.name}"].astype(np.float64).tolist()
                for f in dataclasses.fields(Almanac) if f.name != "prn"}
        alms = {}
        for i, prn in enumerate(z["alm_prns"].tolist()):
            a = Almanac(prn=int(prn))
            for name, col in cols.items():
                setattr(a, name, col[i])
            alms[int(prn)] = a
        out["almanac"] = alms
    chan = {k[5:]: v for k, v in z.items() if k.startswith("chan_")}
    if chan:
        n_chan = len(next(iter(chan.values())))
        # fields added after a checkpoint was written keep their defaults
        out["channel_state"] = init_state(n_chan, device)._replace(**{
            k: torch.from_numpy(np.ascontiguousarray(
                v.astype(bool) if k in _BOOL_FIELDS else v.astype(np.float32)
            )).to(device)
            for k, v in chan.items() if k in ChannelState._fields})
    if "detections_json" in z:
        out["detections"] = json.loads(bytes(z["detections_json"]).decode())
    if "meta_json" in z:
        out["meta"] = json.loads(bytes(z["meta_json"]).decode())
    return out
