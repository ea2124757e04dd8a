"""The repository's three relations examples on the port: `satisfiable`,
`non_satisfiable` and `bench_synthesis` (`python -m
snark_tpu_torch.examples.<name>`). Host code on `relations/` and the LC
engine."""
