"""Device-resident decoded picture buffer: reference planes live on device
between frames as edge-padded int16 stacks, so per-frame reconstruction
reads references without any host round-trip (the reference's frame pool +
DPB, /root/reference/libovvc/ovdpb.c + ovframepool.c, re-expressed as
device arrays).

Slots are assigned per picture and recycled LRU among frames that are
neither the current picture nor its active references; a future reference
that was evicted is transparently re-uploaded from its host copy (every
output frame is fetched to host for display anyway, so the copy always
exists)."""

from __future__ import annotations

import numpy as np

from openvvc_tpu.tpu.mc_dense import PAD_C, PAD_L

NSLOTS = 18  # VVC DPB max 16 refs + current + slack


class DeviceDpb:
    def __init__(self, pic_w, pic_h, chroma, nslots=NSLOTS):
        import jax.numpy as jnp

        self.pic_w, self.pic_h = pic_w, pic_h
        uw, uh = (pic_w + 3) >> 2, (pic_h + 3) >> 2
        self.uw, self.uh = uw, uh
        H4, W4 = uh * 4, uw * 4
        # the MC pad margins on every side: clipped MVs keep every MC
        # window inside them (mc_dense.PAD_L / PAD_C)
        self.hp = H4 + 2 * PAD_L
        self.wp = W4 + 2 * PAD_L
        self.chroma = chroma
        self.nslots = nslots
        self.y = jnp.zeros((nslots, self.hp, self.wp), jnp.int16)
        if chroma:
            self.hcp = uh * 2 + 2 * PAD_C
            self.wcp = uw * 2 + 2 * PAD_C
            self.cb = jnp.zeros((nslots, self.hcp, self.wcp), jnp.int16)
            self.cr = jnp.zeros((nslots, self.hcp, self.wcp), jnp.int16)
        else:
            self.cb = self.cr = None
        self._owner: dict[int, int] = {}   # id(frame) -> slot
        self._frames: dict[int, object] = {}  # slot -> frame (strong ref ok:
        # replaced on reuse; bounded by nslots)
        self._clock = 0
        self._stamp: dict[int, int] = {}

    def _touch(self, slot):
        self._clock += 1
        self._stamp[slot] = self._clock

    def slot_of(self, frame):
        return self._owner.get(id(frame))

    def alloc(self, frame, pinned_frames):
        """Slot for a new picture; evicts LRU among non-pinned slots."""
        pin = {id(f) for f in pinned_frames if f is not None}
        pin.add(id(frame))
        free = [s for s in range(self.nslots) if s not in self._frames]
        if free:
            slot = free[0]
        else:
            cand = [s for s, f in self._frames.items() if id(f) not in pin]
            slot = min(cand, key=lambda s: self._stamp.get(s, 0))
            self._owner.pop(id(self._frames[slot]), None)
        self._frames[slot] = frame
        self._owner[id(frame)] = slot
        self._touch(slot)
        return slot

    def _pad_np(self, plane, pad, th, tw):
        H, W = plane.shape
        return np.pad(plane.astype(np.int16),
                      ((pad, th - H - pad), (pad, tw - W - pad)),
                      mode="edge")

    def upload(self, frame, pinned_frames):
        """Host frame -> device slot (fallback frames, evicted refs)."""
        slot = self.slot_of(frame)
        if slot is not None:
            self._touch(slot)
            return slot
        slot = self.alloc(frame, pinned_frames)
        y = self._pad_np(np.asarray(frame.y), PAD_L, self.hp, self.wp)
        self.y = self.y.at[slot].set(y)
        if self.chroma:
            cb = self._pad_np(np.asarray(frame.cb), PAD_C, self.hcp, self.wcp)
            cr = self._pad_np(np.asarray(frame.cr), PAD_C, self.hcp, self.wcp)
            self.cb = self.cb.at[slot].set(cb)
            self.cr = self.cr.at[slot].set(cr)
        return slot

    def ensure_refs(self, refs, pinned):
        """Upload any reference frame that lost its slot; returns nothing —
        slots are queried via slot_of afterwards."""
        for f in refs or ():
            if self.slot_of(f) is None:
                f.sync_host() if hasattr(f, "sync_host") else None
                self.upload(f, pinned)
            else:
                self._touch(self.slot_of(f))
