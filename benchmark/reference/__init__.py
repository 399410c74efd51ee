"""Plain references the outputs are judged against."""
