"""Host-side utility kit (the reference's replayq / emqx_misc corner)."""
