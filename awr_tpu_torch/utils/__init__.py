"""Host utilities: a PNG writer and a profiler trace."""
