"""Prefix-affinity keys and rendezvous (HRW) replica ranking (copy of
`first_page_key` and `rendezvous_rank` from kubeflow_tpu/routing/
affinity.py, the two the replica's page handoff uses).

Two requests whose prompts share their first page-aligned chunk (the
unit the radix prefix cache commits) hash to the same key, and a key
ranks the same replica first for as long as that replica is in the
fleet. Rendezvous hashing reassigns, when one replica joins or leaves,
only the keys that ranked it first. Keys come from the wire-level
`prompt_ids` integers, so no tokenizer is loaded. The hashes are the
JAX package's, so both packages send a key to the same replica.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List, Sequence


def first_page_key(token_ids: Sequence, page_size: int) -> str:
    """Stable affinity key of one prompt row: its first `page_size`
    token ids (the first committed page). A prompt shorter than a page
    keys on what it has."""
    n = max(1, int(page_size))
    head = ",".join(str(int(t)) for t in list(token_ids)[:n])
    return hashlib.sha1(head.encode("ascii")).hexdigest()


def rendezvous_rank(key: str, replica_ids: Iterable[str]) -> List[str]:
    """Highest-random-weight order of `replica_ids` for `key`: each (key,
    replica) pair gets an independent score and the ranking sorts by it,
    so removing a replica only promotes the second choice of the keys it
    owned, and adding one takes only the keys it now scores highest
    for."""

    def score(rid: str) -> str:
        return hashlib.sha1(f"{key}|{rid}".encode("utf-8")).hexdigest()

    return sorted(replica_ids, key=score, reverse=True)
