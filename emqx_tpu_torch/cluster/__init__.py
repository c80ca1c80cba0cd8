"""Cluster plane (SURVEY.md §5 'distributed communication backend'):

1. control RPC + replication transport (Erlang-dist / mria-rlog slot)
2. per-topic-ordered message forwarding (gen_rpc slot)
3. BPAPI-style versioned protos with frozen-signature snapshots
4. membership + failure detection with route purge on nodedown

Transports: in-process ``LocalBus`` (the ct_slave-style multi-node-
on-one-host test harness) and length-prefixed TCP (the DCN path).
"""
