"""REST plumbing shared by the port's servers."""
