"""Config & control plane (SURVEY.md §1 L11): HOCON-subset parser,
typed schema, layered config store with per-path update handlers."""
