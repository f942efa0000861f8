"""Sharded serving over ``torch.distributed``: the PIMnast mesh planner
(``sharding``), the activation anchors (``axes``) and the collectives
(``collectives``)."""
