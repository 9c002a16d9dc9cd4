"""The serving tier's remote embedding: ``RemoteEmbedClient``.

The counterpart of ``repro.runtime.tenancy.RemoteEmbedClient``; the
tenant router and QoS classes of that module wait for the tenancy slice
(ROADMAP.md section 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Cluster
from .embed_service import EmbedShardService


class RemoteEmbedClient:
    """Embedding rows as a service: the LM decode loop's token embeddings
    fetched through CQ-tracked gathers instead of a local table lookup.

    Owns a private cluster whose servers hold the (row-padded, f32)
    embedding table; :meth:`rows` chunks a token batch into ``n_keys``-row
    gathers and reassembles the result.  Rows travel bit-exactly (f32
    bit-cast through the int32 CQ words), so a decode stream fed by this
    client is bit-identical to the local-embed stream.  On the card each
    server resolves its rows with the ``embed_lookup`` kernel.
    """

    def __init__(
        self,
        embed_table: np.ndarray,
        n_servers: int = 2,
        n_keys: int = 8,
        max_slots: int = 16,
        device: "torch.device | str | None" = None,
    ) -> None:
        table = np.asarray(embed_table, np.float32)
        self.vocab = table.shape[0]
        pad = (-self.vocab) % n_servers
        if pad:
            table = np.concatenate([table, np.zeros((pad, table.shape[1]), np.float32)])
        self.cluster = Cluster(n_servers, device=device)
        self.service = EmbedShardService(
            self.cluster,
            vocab=table.shape[0],
            dim=table.shape[1],
            n_keys=n_keys,
            max_slots=max_slots,
            table=table,
        )
        self.gathers = 0  # CQ-tracked gather requests issued

    def rows(self, ids: np.ndarray) -> np.ndarray:
        """Fetch embedding rows for ``ids`` (any shape) via the service."""
        ids = np.asarray(ids, np.int32)
        flat = ids.reshape(-1)
        n = self.service.n_keys
        batches = [flat[i : i + n] for i in range(0, len(flat), n)]
        report = self.service.gather(batches)
        self.gathers += len(batches)
        out = np.concatenate(report.results, axis=0)
        return out.reshape(*ids.shape, -1)
