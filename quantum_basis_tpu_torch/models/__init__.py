"""The Model orchestration object."""
