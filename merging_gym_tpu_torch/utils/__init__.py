"""Runtime checks (``debug``) and tracing and timing (``profiling``)."""
