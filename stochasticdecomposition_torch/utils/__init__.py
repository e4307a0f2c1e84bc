"""Result files and console summaries."""
