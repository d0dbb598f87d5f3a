"""The yardstick: generators, roofline arithmetic and the plain references.

Plain PyTorch and NumPy only: nothing here imports the port, JAX or the JAX
package, and nothing here takes what the port has made.
"""
