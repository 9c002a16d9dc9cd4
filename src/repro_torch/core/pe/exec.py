"""Execution layer: invoke installed executables and apply the fixed
X-RDMA action protocol their results encode.

ABI — how the runtime and injected code meet
--------------------------------------------
The paper's ifunc entry is ``main(payload, payload_size, target_ptr)`` and
may call UCX itself (via remote dynamic linking) to recursively re-inject
itself.  A traced program cannot call back into the transport mid-flight,
so the rendering here keeps the *decision logic in the shipped
code* and leaves only a fixed, function-agnostic action protocol in the
runtime (the moral equivalent of the UCX API the paper's ifuncs link
against):

* ``update`` ABI — ``entry(payload, region) -> new_region``.  The runtime
  stores the result back into the named memory region (TSI's counter).
* ``xrdma`` ABI — ``entry(payload, *linked_deps) -> i64[ACTION_WIDTH]``
  action vector::

      [action, dst, plen, p0 .. p7]

  ``action``: 0 DONE | 1 FORWARD (re-inject *this same ifunc*, code and
  all, to peer ``dst`` with payload ``p[:plen]``) | 2 RETURN (send the
  ifunc named by the ``returns:`` dep to ``dst``) | 3 SPAWN (send the
  ifunc named by the ``spawn:`` dep — "generate new code") | 4 NOP
  (no action; skipped by the runtime) | 5 PUBLISH (re-publish *this same
  ifunc* to peer ``dst`` under a fresh propagation hop header — ``p0`` is
  the hop ttl, ``p[1:plen]`` the published payload; this is how shipped
  code recursively propagates itself, Sec. I).
* ``propagate`` ABI — ``entry(payload, region, *deps) -> (new_region,
  actions)``: one entry both folds into its linked region (like
  ``update``) *and* emits action rows (like ``xrdma``) — what a tree
  reduction needs: the row whose fold completes the subtree emits the
  upward FORWARD.  Under the batched runtime the payloads fold in order
  in one dispatch, each valid row keeping its own actions.

  An xrdma entry may instead return an ``(R, W)`` i32 *matrix* of action
  rows; the runtime applies the rows in order.  ``W`` only has to satisfy
  ``W >= 3 + plen`` for every row — rows are self-describing via their
  ``plen`` field, so one rectangular matrix carries ragged payloads.  NOP
  rows are how statically-shaped shipped code emits a *variable* number
  of actions.

  Local recursion — the paper's "ifunc calls itself recursively" when the
  next pointer is local — happens *inside* the shipped code, as one call
  of the ``repro_torch::chase_shard`` custom op: the blob chases until the
  frontier leaves its shard, then emits FORWARD.  One network action per locality break, exactly the
  paper's DAPC behaviour.

The layer is transport-blind: every action that must travel (FORWARD,
RETURN, SPAWN, PUBLISH) is handed to the runtime facade (the ``actions``
collaborator), which owns protocol selection and the wire layer.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from ..cache import CachedExecutable
from ..frame import ProtocolError
from .. import verify as _verify_codes

if TYPE_CHECKING:  # pragma: no cover - annotations only
    from .codecache import CodeCacheLayer

ACTION_WIDTH = 11  # [action, dst, plen, p0..p7]
A_DONE, A_FORWARD, A_RETURN, A_SPAWN, A_NOP, A_PUBLISH = 0, 1, 2, 3, 4, 5

# core/verify.py mirrors these codes (importing this package there would
# cycle through the pe facade); keep the two in lockstep
assert (A_DONE, A_FORWARD, A_RETURN, A_SPAWN, A_NOP, A_PUBLISH) == (
    _verify_codes.A_DONE, _verify_codes.A_FORWARD, _verify_codes.A_RETURN,
    _verify_codes.A_SPAWN, _verify_codes.A_NOP, _verify_codes.A_PUBLISH,
)


# --------------------------------------------------------- dep-list helpers
def dep_named(exe: CachedExecutable, tag: str) -> str | None:
    """First ``tag:<value>`` entry on the executable's dep list, if any."""
    for d in exe.deps:
        t, _, val = d.partition(":")
        if t == tag:
            return val
    return None


def region_arg_pos(exe: CachedExecutable) -> int:
    """Position of the (single) region among the linked dep arguments."""
    pos = 0
    for d in exe.deps:
        tag, _, _ = d.partition(":")
        if tag == "region":
            return pos
        if tag == "cap":
            pos += 1
    raise AssertionError("update ABI requires a region dep")


class ExecLayer:
    """Invoke + action application for one PE.

    ``rt`` is the runtime facade (:class:`repro_torch.core.pe.pe.PE`): it links
    dep arguments (regions as device-resident mirrors, capabilities),
    stores update-ABI results back, collects DONE payloads, and carries
    the travelling actions to the wire.
    """

    def __init__(self, rt, codecache: "CodeCacheLayer", stats, verifier=None) -> None:
        self.rt = rt
        self.codecache = codecache
        self.stats = stats  # the PE's PEStats (shared across layers)
        self.verifier = verifier  # the PE's sandbox ledger (None in bare tests)

    # --- payload/dep decoding ---------------------------------------------
    @staticmethod
    def _pad_ragged(aval, payload: bytes) -> bytes:
        """Zero-extend a ragged payload to the entry's declared aval.

        An xrdma action row's self-describing ``plen`` lets the *send* side
        ship only the meaningful prefix (e.g. a Filter RETURN carrying just
        the survivor rows).  The executable's input shape is static, so an
        entry that declares the ``ragged:`` dep tag opts into receiver-side
        zero-padding — its semantics must not depend on the padded tail
        (the Filter fold scatters by position and drops ``-1`` slots).  A
        payload *longer* than the declared aval is still a protocol error.
        """
        want = int(np.prod(aval.shape)) * aval.np_dtype.itemsize
        if len(payload) > want:
            raise ProtocolError(
                f"ragged payload of {len(payload)} B exceeds declared {want} B"
            )
        if len(payload) < want:
            payload = bytes(payload) + b"\0" * (want - len(payload))
        return payload

    @staticmethod
    def decode_payload(exe: CachedExecutable, payload: bytes) -> np.ndarray:
        aval = exe.in_avals[0]
        if dep_named(exe, "ragged") is not None:
            payload = ExecLayer._pad_ragged(aval, payload)
        arr = np.frombuffer(payload, dtype=aval.np_dtype)
        return arr.reshape(aval.shape)

    @staticmethod
    def decode_payload_block(
        exe: CachedExecutable, pays: list[bytes], bucket: int
    ) -> np.ndarray:
        """Decode N same-type payloads into a ``(bucket, ...)`` block.

        Padding rows repeat the last real payload: a real payload is known
        to terminate (e.g. a Chaser's depth bound), so edge-repeat
        padding can never hang where zero-padding might; padded outputs are
        simply discarded.
        """
        aval = exe.in_avals[0]
        if dep_named(exe, "ragged") is not None:
            pays = [ExecLayer._pad_ragged(aval, p) for p in pays]
        arr = np.frombuffer(b"".join(pays), dtype=aval.np_dtype)
        arr = arr.reshape((len(pays), *aval.shape))
        if bucket > len(pays):
            arr = np.concatenate([arr, np.repeat(arr[-1:], bucket - len(pays), axis=0)])
        return arr

    def _dep_args(self, exe: CachedExecutable) -> list[Any]:
        args: list[Any] = []
        for d in exe.deps:
            tag, _, val = d.partition(":")
            if tag == "region":
                args.append(self.rt.region_device(val))
            elif tag == "cap":
                args.append(self.rt.cap_device(val))
        return args

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of a decoded payload (or block)."""
        return torch.from_numpy(np.array(arr)).to(self.rt.device)

    @staticmethod
    def _host(out: torch.Tensor) -> np.ndarray:
        """One device-to-host copy of what a dispatch returned."""
        return out.cpu().numpy()

    # --- invoke -------------------------------------------------------------
    def invoke(self, exe: CachedExecutable, payload: bytes) -> None:
        ver = self.verifier
        if ver is not None and ver.config.enabled:
            # retire-time quota charge, before the dispatch: code over its
            # payload/invoke budget is refused + quarantined, never run
            ver.charge_invoke(exe, [len(payload)])
        self.stats.invokes += 1
        self.stats.invoked_payloads += 1
        pay = self._to_device(self.decode_payload(exe, payload))
        args = self._dep_args(exe)
        out = exe.fn(pay, *args)
        abi = exe.extras.get("abi", "pure")
        if abi == "update":
            region = dep_named(exe, "region")
            assert region is not None, "update ABI requires a region dep"
            self.rt.write_region(region, self._host(out), out)
        elif abi == "propagate":
            region = dep_named(exe, "region")
            assert region is not None, "propagate ABI requires a region dep"
            new_region, actions = out
            self.rt.write_region(region, self._host(new_region), new_region)
            self.apply_actions(exe, self._host(actions))
        elif abi == "xrdma":
            self.apply_actions(exe, self._host(out))
        else:  # pure
            self.rt.completed.append(self._host(out))

    def invoke_batch(self, exe: CachedExecutable, pays: list[bytes]) -> None:
        """Retire N same-ifunc payloads in one dispatch."""
        if len(pays) == 1:  # the per-message executable is already compiled
            self.invoke(exe, pays[0])
            return
        ver = self.verifier
        if ver is not None and ver.config.enabled:
            ver.charge_invoke(exe, [len(p) for p in pays])
        n = len(pays)
        bucket = self.codecache.bucket(n)
        block = self._to_device(self.decode_payload_block(exe, pays, bucket))
        fn = self.codecache.batched_executable(exe, bucket)
        args = self._dep_args(exe)
        abi = exe.extras.get("abi", "pure")
        self.stats.invokes += 1
        self.stats.batched_invokes += 1
        self.stats.invoked_payloads += n
        if abi in ("update", "propagate"):
            region = dep_named(exe, "region")
            assert region is not None, f"{abi} ABI requires a region dep"
            valid = np.arange(bucket) < n
            rpos = region_arg_pos(exe)
            extra = [a for i, a in enumerate(args) if i != rpos]
            out, acts = fn(block, valid, args[rpos], *extra), None
            if abi == "propagate":
                out, acts = out
            self.rt.write_region(region, self._host(out), out)
            if acts is not None:
                # padded rows came back as NOPs; applying the real rows in
                # payload order keeps the sequential semantics (the row
                # that completes a fold emits the action)
                for per_payload in self._host(acts)[:n]:
                    self.apply_actions(exe, per_payload)
        elif abi == "xrdma":
            actions = self._host(fn(block, *args))[:n]
            for per_payload in actions:
                self.apply_actions(exe, per_payload)
        else:  # pure
            outs = self._host(fn(block, *args))[:n]
            self.rt.completed.extend(outs)

    # --- action application ---------------------------------------------------
    def apply_actions(self, exe: CachedExecutable, out: np.ndarray) -> None:
        """Apply what an xrdma entry returned: one action vector, or an
        (R, W) matrix of action rows applied in order (see module docstring)."""
        if out.ndim == 2:
            for row in out:
                self.apply_action(exe, row)
        else:
            self.apply_action(exe, out)

    def apply_action(self, exe: CachedExecutable, action: np.ndarray) -> None:
        """The fixed X-RDMA action protocol (see module docstring)."""
        code = int(action[0])
        dst_idx = int(action[1])
        plen = int(action[2])
        pay = np.ascontiguousarray(action[3 : 3 + plen])
        if code == A_NOP:
            return
        ver = self.verifier
        if ver is not None and ver.config.enabled:
            # capability-stamp action whitelist + cumulative action/fan-out
            # quotas; a refused row quarantines the digest before dispatch
            ver.charge_action(exe, code)
        if code == A_DONE:
            self.rt.completed.append(pay)
            return
        dst = self.rt.peers[dst_idx]
        if code == A_FORWARD:
            self.stats.forwards += 1
            self.rt.forward_ifunc(dst, exe, pay)
        elif code == A_RETURN:
            self.stats.returns += 1
            target = dep_named(exe, "returns")
            assert target is not None, "RETURN requires a returns: dep"
            self.rt.return_payload(dst, target, pay)
        elif code == A_SPAWN:
            self.stats.spawns += 1
            target = dep_named(exe, "spawn")
            assert target is not None, "SPAWN requires a spawn: dep"
            self.rt.send_ifunc(dst, target, pay)
        elif code == A_PUBLISH:
            # shipped code re-publishing *itself*: p0 is the hop budget it
            # grants, the rest travels as the published payload — the
            # paper's "recursively propagate itself" emitted by the code,
            # not the runtime
            self.rt.publish_self(dst, exe, pay)
        else:
            raise ProtocolError(f"bad action code {code}")
