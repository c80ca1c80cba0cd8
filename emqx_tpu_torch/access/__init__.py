"""Security layer (SURVEY.md §1 L7): authn chains, authz sources,
banned table, flapping detector, per-connection authz cache."""
