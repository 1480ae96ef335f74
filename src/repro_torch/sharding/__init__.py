from repro_torch.sharding.rules import (
    Rules,
    TRAIN_RULES,
    SERVE_RULES,
    rules_for,
    logical_to_spec,
    named_sharding_for,
    param_shardings,
    shard_act,
    use_param,
    use_rules,
    current_rules,
)

__all__ = [
    "Rules", "TRAIN_RULES", "SERVE_RULES", "rules_for", "logical_to_spec",
    "named_sharding_for", "param_shardings", "shard_act", "use_param",
    "use_rules", "current_rules",
]
