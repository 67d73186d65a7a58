"""Traffic: one data file per mix (`<mix>.json`, named by a cell's
`traffic`) and one general driver per kind (`<driver>.py`, named by the
mix's `driver`)."""
