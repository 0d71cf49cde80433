"""Training data of the port (a framework-free copy of the JAX
package's ``data``)."""
