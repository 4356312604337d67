"""Optimizers, schedules and timers of the port."""
