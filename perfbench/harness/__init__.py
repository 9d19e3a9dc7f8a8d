"""The benchmark's harness: what a run does, finds, copies and reduces."""
