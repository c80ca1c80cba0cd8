"""Management plane (SURVEY.md §1 L11): REST API (minirest analogue),
API-key/JWT auth, CLI verbs (emqx_ctl analogue)."""
