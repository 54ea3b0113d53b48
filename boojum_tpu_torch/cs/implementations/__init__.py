from .reference_cs import ConstraintSystem, CSAssembly, FieldCapacityError
