"""Checkpoint/resume for the receiver state machine.

The reference has no on-disk checkpointing, but its whole design is a
checkpointable state machine: all inter-block state is explicit,
enumerable, and tiny (STATES struct src/project.cpp:29-36,446-468;
SURVEY.md §5 "Checkpoint / resume").  The contract: a block-k restart from
saved state is bit-identical to uninterrupted streaming.  Here the state
is already a flat pytree (sdr_fm.models.receiver.ReceiverState), so a
checkpoint is one ``.npz`` per state plus the CDR/framesync host-side
carry.

For large channel batches the same pytree round-trips through orbax
(``save_orbax``/``load_orbax``) for sharded multi-host checkpoints.
"""

from __future__ import annotations

import json
import os
from typing import Any

import jax
import numpy as np

from sdr_fm import config as cfg
from sdr_fm.models import receiver as rx


def _flatten_with_paths(state: rx.ReceiverState) -> dict[str, np.ndarray]:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        key = "/".join(getattr(p, "name", str(getattr(p, "idx", p)))
                       for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def save(path: str, state: rx.ReceiverState, mode: int | cfg.Mode,
         block_count: int = 0, extra: dict[str, Any] | None = None,
         host_arrays: dict[str, np.ndarray] | None = None,
         input_dtype: str | None = None) -> str:
    """Write state + metadata to ``<path>`` (.npz appended if missing);
    returns the path actually written (np.savez appends the extension
    silently, so callers must report THIS name).

    ``extra`` is JSON-able metadata; ``host_arrays`` carries host-side
    decoder state (e.g. the streaming RDS carry — CDR state, bit backlog,
    pending frames: models.rds_decode.StreamingRdsDecoder.state_dict) so
    a resume reproduces the uninterrupted output stream exactly, device
    AND host side.

    ``input_dtype`` ("uint8" / "float32") records what the receiver was
    fed: the u8 fast path assumes the carried RF tail is 1/128-quantized
    (models.receiver.process_block state-dtype contract), so resuming a
    float-produced checkpoint with raw-u8 input would silently corrupt
    one block — ``load`` refuses the mismatch instead.
    """
    if not path.endswith(".npz"):
        path = path + ".npz"
    flat = _flatten_with_paths(state)
    meta = {"mode": int(mode), "block_count": int(block_count),
            "extra": extra or {}}
    if input_dtype is not None:
        meta["input_dtype"] = str(np.dtype(input_dtype))
    host = {f"host/{k}": np.asarray(v)
            for k, v in (host_arrays or {}).items()}
    np.savez(path, __meta__=json.dumps(meta), **flat, **host)
    return path


def load(path: str, expect_input_dtype: str | None = None
         ) -> tuple[rx.ReceiverState, dict[str, Any]]:
    """Read a checkpoint; returns (state, meta).  Host-side arrays saved
    via ``host_arrays`` come back under ``meta["host_arrays"]``.

    ``expect_input_dtype``: the dtype the resumed run will feed.  A
    checkpoint recorded with a different ``input_dtype`` raises
    ValueError (resuming float-produced state with raw u8 would silently
    quantize the carried RF tail — the state-dtype contract,
    models.receiver.process_block); a legacy checkpoint with no record
    gets a stderr warning plus a direct host-side tail check when the
    resumed run expects u8."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        mc = cfg.get_mode_config(meta["mode"])
        template = rx.init_state(mc)
        flat = _flatten_with_paths(template)
        batchless = {k: z[k] for k in flat}
        meta["host_arrays"] = {k[len("host/"):]: z[k] for k in z.files
                               if k.startswith("host/")}
    if expect_input_dtype is not None:
        expect = str(np.dtype(expect_input_dtype))
        stored = meta.get("input_dtype")
        if stored is not None and stored != expect:
            raise ValueError(
                f"checkpoint {path} was produced from {stored} input but "
                f"the resumed run feeds {expect}: the u8 fast path "
                "requires a 1/128-quantized RF tail, so this resume would "
                "silently corrupt the stream (models.receiver."
                "process_block state-dtype contract).  Feed the same "
                "input dtype, or re-create the checkpoint.")
        if stored is None and expect == "uint8":
            import sys
            print(f"warning: checkpoint {path} predates input-dtype "
                  "recording; validating the RF tail directly",
                  file=sys.stderr)
            rx.validate_u8_rf_state(batchless["rf_i"], batchless["rf_q"])
    leaves = [jax.numpy.asarray(batchless[k]) for k in flat]
    treedef = jax.tree_util.tree_structure(template)
    # tree_flatten_with_path and tree_structure enumerate leaves in the
    # same (deterministic) order for a NamedTuple pytree
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    return state, meta


def save_orbax(dirpath: str, state: rx.ReceiverState) -> None:
    """Sharded checkpoint via orbax (multi-host channel batches)."""
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(dirpath), state, force=True)
    ckptr.wait_until_finished()


def load_orbax(dirpath: str, template: rx.ReceiverState) -> rx.ReceiverState:
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(os.path.abspath(dirpath), template)
