"""The DiFuseR core of the port: sampling, sketch state, fixpoints, seed
selection and the Alg. 4 driver."""
