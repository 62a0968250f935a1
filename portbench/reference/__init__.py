"""Plain float64 references of the diagnostics the cells drive, in PyTorch
on the sample's device, in blocks of parameters. They import nothing of the
program under test and take nothing it made: only the generated sample and
the configuration. A mix names its reference as ``<module>.<function>``."""
