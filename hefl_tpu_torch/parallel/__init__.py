"""Host-side topology helpers of the two-tier aggregation.

Counterpart of the numpy-only helpers of `hefl_tpu.parallel`
(`mesh.host_of_clients`, `mesh.dcn_link_names`,
`collectives.dcn_traffic_model`). One GPU has no device mesh: the hosts
here are the simulated regions of the hierarchical fold tree
(`fl.hierarchy`), whose client -> host layout the regional-outage fault
schedule (`fl.faults`) shares.
"""

from __future__ import annotations

import numpy as np


def host_of_clients(num_clients: int, num_hosts: int) -> np.ndarray:
    """int64[num_clients]: which host owns each client slot — host h owns
    the contiguous block of ceil(num_clients / num_hosts) slots from
    h * ceil(num_clients / num_hosts). The hierarchical tier
    (`fl.hierarchy`) and the regional-outage schedule (`fl.faults`) both
    key off this map, so "a host's cohort block" means the same clients
    everywhere."""
    if num_hosts < 1:
        raise ValueError(f"host_of_clients: num_hosts={num_hosts} must be >= 1")
    if num_clients < num_hosts:
        raise ValueError(
            f"host_of_clients: {num_hosts} hosts over {num_clients} clients "
            "would leave empty host rows; use num_hosts <= num_clients"
        )
    per_host = -(-num_clients // num_hosts)
    return np.arange(num_clients, dtype=np.int64) // per_host


def dcn_link_names(num_hosts: int) -> tuple[str, ...]:
    """The simulated cross-region uplinks of the two-tier topology: one
    host->root link per host (h{h}_root). Per-link byte counters ride the
    obs registry as `dcn.link.<name>.bytes` (`fl.hierarchy`)."""
    return tuple(f"h{h}_root" for h in range(int(num_hosts)))


def dcn_traffic_model(
    num_participants: int,
    num_hosts: int,
    ct_nbytes: int,
    participants_per_host: tuple[int, ...] | None = None,
) -> dict:
    """Per-round cross-host byte cost of the two aggregation topologies.

    Flat aggregation ships every participant's ciphertext to one root:
    `num_participants * ct_nbytes`. The hierarchical fold ships exactly
    ONE partial ciphertext per host that holds any participant: at most
    `num_hosts * ct_nbytes`. `participants_per_host` (when known) counts
    only the nonempty hosts — an outage-darkened host ships nothing. This
    is what the `dcn.link.*` counters of `fl.hierarchy` measure."""
    if num_participants < 0 or num_hosts < 1 or ct_nbytes < 1:
        raise ValueError(
            f"dcn_traffic_model: participants={num_participants} "
            f"hosts={num_hosts} ct_nbytes={ct_nbytes}"
        )
    if participants_per_host is not None:
        if len(participants_per_host) != num_hosts:
            raise ValueError(
                f"participants_per_host has {len(participants_per_host)} "
                f"entries for {num_hosts} hosts"
            )
        if sum(participants_per_host) != num_participants:
            raise ValueError(
                f"participants_per_host sums to {sum(participants_per_host)}"
                f", expected {num_participants}"
            )
        shipping = sum(1 for n in participants_per_host if n > 0)
    else:
        shipping = min(num_hosts, num_participants)
    flat = num_participants * ct_nbytes
    hier = shipping * ct_nbytes
    return {
        "num_participants": int(num_participants),
        "num_hosts": int(num_hosts),
        "shipping_hosts": int(shipping),
        "ct_bytes": int(ct_nbytes),
        "flat_dcn_bytes": int(flat),
        "hier_dcn_bytes": int(hier),
        "bytes_ratio": (flat / hier) if hier else float("inf"),
    }


__all__ = ["host_of_clients", "dcn_link_names", "dcn_traffic_model"]
