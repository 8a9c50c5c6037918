"""Optimizers (`optimizers`) and learning-rate schedules (`schedules`)."""
