"""Classification metrics."""
