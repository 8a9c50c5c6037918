"""Serving: the fault types (`faults`), the lockstep scheduler
(`scheduler`) and the CNN server (`serve`)."""
