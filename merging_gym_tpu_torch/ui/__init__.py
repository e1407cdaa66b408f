"""The human experiment harness: pygame renderer, protocol screens and
the session loop with its scripted opponents."""
