"""Time-MMD on the port: the dataset loader, its configs, the fold loader and the cache CLI.

The port's own copy of ``examples/time_mmd/`` (which imports the JAX
package): nothing here imports pandas, and YAML is read only by the CLI.
"""
