"""Host-side utilities: the structured metrics stream."""
