"""Command-line front-ends."""
