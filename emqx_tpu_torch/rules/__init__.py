"""SQL rule engine — parity with
``apps/emqx_rule_engine``: SQL over hook events, builtin function
library, republish/console/custom actions."""
